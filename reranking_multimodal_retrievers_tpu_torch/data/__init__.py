from .pipeline import DataPipeline
from .transforms import BaseTransform, RowWiseTransform, HFDatasetTransform
from .cache_system import cache_data_to_disk, load_data_from_disk
from .table import Table, concatenate_tables

__all__ = [
    "DataPipeline",
    "BaseTransform",
    "RowWiseTransform",
    "HFDatasetTransform",
    "cache_data_to_disk",
    "load_data_from_disk",
    "Table",
    "concatenate_tables",
]

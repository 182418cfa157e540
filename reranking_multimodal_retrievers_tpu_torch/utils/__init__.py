from .registries import (
    Executor_Registry,
    DataTransform_Registry,
    Model_Registry,
    register_executor,
    register_transform_functor,
    register_model,
)
from .config_system import load_config, apply_opts, ConfigDict
from .seed import set_seed

__all__ = [
    "Executor_Registry",
    "DataTransform_Registry",
    "Model_Registry",
    "register_executor",
    "register_transform_functor",
    "register_model",
    "load_config",
    "apply_opts",
    "ConfigDict",
    "set_seed",
]

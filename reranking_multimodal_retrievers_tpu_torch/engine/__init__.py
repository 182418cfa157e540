from .index import QuantizedTokenIndex, TokenIndex, encode_corpus
from .rerank_eval import make_chunked_rerank_fn, make_decoder_rerank_fn
from .search import Searcher, make_search_fn, make_search_fn_int8, search_exhaustive
from .streaming import HostQuantizedTokenIndex, HostTokenIndex, StreamingSearcher
from .data import Collection, Examples, Queries, Ranking
from .infra import EngineConfig, Provenance, Run
from .compress import pool_doc_tokens, pool_index
from . import utility

__all__ = [
    "TokenIndex",
    "QuantizedTokenIndex",
    "encode_corpus",
    "Searcher",
    "make_search_fn",
    "make_search_fn_int8",
    "search_exhaustive",
    "make_chunked_rerank_fn",
    "make_decoder_rerank_fn",
    "HostTokenIndex",
    "HostQuantizedTokenIndex",
    "StreamingSearcher",
    "Queries",
    "Collection",
    "Ranking",
    "Examples",
    "EngineConfig",
    "Provenance",
    "Run",
    "pool_doc_tokens",
    "pool_index",
    "utility",
]

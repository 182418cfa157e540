from .index import TokenIndex, encode_corpus
from .rerank_eval import make_chunked_rerank_fn
from .search import Searcher, make_search_fn, search_exhaustive

__all__ = [
    "TokenIndex",
    "encode_corpus",
    "Searcher",
    "make_search_fn",
    "search_exhaustive",
    "make_chunked_rerank_fn",
]

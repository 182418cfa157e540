from .index import QuantizedTokenIndex, TokenIndex, encode_corpus
from .rerank_eval import make_chunked_rerank_fn, make_decoder_rerank_fn
from .search import Searcher, make_search_fn, make_search_fn_int8, search_exhaustive
from .streaming import HostQuantizedTokenIndex, HostTokenIndex, StreamingSearcher

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
]

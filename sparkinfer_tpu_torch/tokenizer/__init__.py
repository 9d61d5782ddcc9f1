from .vocab import Vocab, build_tokenizer
from .spm import SPMTokenizer
from .bpe import BPETokenizer
from .ugm import UGMTokenizer
from .rwkv import RWKVTokenizer

__all__ = ["Vocab", "build_tokenizer", "SPMTokenizer", "BPETokenizer",
           "UGMTokenizer", "RWKVTokenizer"]

from .pool import BucketedPool
from .text import MonoTextData, TextBatch
from .vocab import Vocab

__all__ = ["BucketedPool", "MonoTextData", "TextBatch", "Vocab"]

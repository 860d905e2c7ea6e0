from .omniglot import ensure_omniglot_dataset, image_batches, load_omniglot
from .pool import BucketedPool, ImagePool, Pool
from .synthetic import ensure_synthetic_dataset, generate_synthetic_corpus
from .text import MonoTextData, TextBatch
from .vocab import Vocab

__all__ = ["BucketedPool", "ImagePool", "Pool", "MonoTextData", "TextBatch", "Vocab",
           "ensure_omniglot_dataset", "ensure_synthetic_dataset", "generate_synthetic_corpus",
           "image_batches", "load_omniglot"]

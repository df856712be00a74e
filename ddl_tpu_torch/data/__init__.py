from .lm import LMDataset, synthesize_copy
from .mnist import Dataset, load_mnist, one_hot, synthesize

__all__ = ["Dataset", "LMDataset", "load_mnist", "one_hot", "synthesize", "synthesize_copy"]

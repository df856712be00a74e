from .mnist import Dataset, load_mnist, one_hot, synthesize

__all__ = ["Dataset", "load_mnist", "one_hot", "synthesize"]

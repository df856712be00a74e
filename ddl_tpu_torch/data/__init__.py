from .lm import LMDataset, synthesize_copy, synthesize_prompts, synthesize_shared_prefix_prompts
from .mnist import Dataset, load_mnist, one_hot, synthesize

__all__ = ["Dataset", "LMDataset", "load_mnist", "one_hot", "synthesize", "synthesize_copy",
           "synthesize_prompts", "synthesize_shared_prefix_prompts"]

from .lm import (
    DEFAULT_TRAFFIC_CLASSES,
    LMDataset,
    MixedRequest,
    synthesize_copy,
    synthesize_longtail_prompts,
    synthesize_mixed_traffic,
    synthesize_prompts,
    synthesize_shared_prefix_prompts,
)
from .mnist import Dataset, load_mnist, one_hot, synthesize

__all__ = ["DEFAULT_TRAFFIC_CLASSES", "Dataset", "LMDataset", "MixedRequest", "load_mnist",
           "one_hot", "synthesize", "synthesize_copy", "synthesize_longtail_prompts",
           "synthesize_mixed_traffic",
           "synthesize_prompts", "synthesize_shared_prefix_prompts"]

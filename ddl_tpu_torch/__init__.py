"""ddl_tpu_torch — the PyTorch/CUDA port of ``ddl_tpu``.

A second package beside the JAX one, which stays as the reference. It
imports ``torch``, numpy and the standard library only: nothing of JAX and
nothing of ``ddl_tpu``. Every Pallas TPU kernel on a ported path becomes a
kernel written by hand for Hopper (``csrc/``); convs, matmuls and
collectives go to cuDNN, cuBLAS and NCCL, as XLA handled them in JAX.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise.

Layout:
    data/       MNIST pipeline (numpy copy of ddl_tpu/data/mnist.py)
    models/     the MNIST CNN, JAX storage layout
    ops/        TF1 Adam, the fused-Adam CUDA kernel and its builder
    parallel/   layout policies, collectives, process worlds
    strategies/ sync DP and ZeRO-1 sharded trainers
    train/      config + single-device trainer
    utils/      step timing
    convert.py  weight carry-over from the JAX package (as numpy)
    csrc/       CUDA sources, built with nvcc at first use
"""

__version__ = "0.1.0"

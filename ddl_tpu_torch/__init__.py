"""ddl_tpu_torch — the PyTorch/CUDA port of ``ddl_tpu``.

A second package beside the JAX one, which stays as the reference. It
imports ``torch``, numpy and the standard library only: nothing of JAX and
nothing of ``ddl_tpu``. Every Pallas TPU kernel on a ported path becomes a
kernel written by hand for Hopper (``csrc/``); convs, matmuls and
collectives go to cuDNN, cuBLAS and NCCL, as XLA handled them in JAX.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise.

Layout:
    data/        MNIST pipeline and the LM copy task (numpy copies of ddl_tpu/data)
    models/      the MNIST CNN and the decoder LM, JAX storage layout
    ops/         TF1 Adam, the fused-Adam and flash-attention CUDA kernels, their builder,
                 the KV-cache ops
    parallel/    layout policies, collectives, process worlds, plain attention
    strategies/  sync DP and ZeRO-1 sharded CNN trainers, the one-device LM trainer
    serve/       single-engine LM serving: KV caches, engine, scheduler, sampling
    train/       config + single-device CNN trainer
    utils/       step timing, parameter trees
    precision.py the fp32 / bf16 precision policy
    convert.py   weight carry-over from the JAX package (as numpy)
    csrc/        CUDA sources, built with nvcc at first use
    tools/       step anatomy on the card
"""

__version__ = "0.1.0"

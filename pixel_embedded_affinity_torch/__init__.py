"""PyTorch/CUDA port of pixel-embedded-affinity, beside the JAX package.

Serving slice: CVPPP 2D inference (``infer.run_inference_2d``,
``infer.run_cvppp_test``, the ``inference`` CLI) with the fused
embedding->affinity kernel written in CUDA for Hopper
(``ops.emb2aff_cuda``, ``csrc/affinity2d.cu``).
"""

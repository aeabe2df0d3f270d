"""PyTorch/CUDA port of pixel-embedded-affinity, beside the JAX package.

Slices: CVPPP 2D serving (``infer.run_inference_2d``, ``infer.run_cvppp_test``,
the ``inference`` CLI) and training (``train.train`` with the ``cvppp``
preset, fused or unfused loss), BBBC039 nuclei serving seeded by the
predicted mask and training with the mask head and the device-resident
sampler (the ``bbbc039v1`` preset), AC3/AC4 3D tiled serving
(``infer.run_inference_3d``) and training (``train.train`` with the
``ac3ac4`` preset), each of them data-parallel over ``torch.distributed``
(``parallel/``, ``train --distributed``). The TPU kernels on those paths
are written in CUDA for Hopper (``csrc/``, wrapped in ``ops/*_cuda.py``).
"""

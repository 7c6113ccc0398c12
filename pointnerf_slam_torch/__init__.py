"""PyTorch/CUDA port of the pointNeRF-SLAM system: sensor-depth, weak-depth
(RGB-only) and NICE modes.

Mirrors the JAX reference package's layout: core, models, render, ops
(hand-written CUDA kernels for sm_90a and their plain PyTorch versions),
frontend, engine, io, outputs, tools, utils, and parallel (the mapper's
rays split over a torch.distributed group, one process per device, and
multi-scene mapping). Entry points run on CUDA unless given device="cpu".
"""

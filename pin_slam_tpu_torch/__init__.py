"""PIN-SLAM in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of `pin_slam_tpu` (the JAX reference package, which stays unchanged
beside it). It imports torch and numpy only, never jax and nothing of
`pin_slam_tpu`. Entry points run on `cuda` unless the caller passes
`device="cpu"`; on the CPU every kernel wrapper runs its plain PyTorch
version instead.

Implemented so far: the per-frame track+map loop in join-probe mode
(`slam.system.PinSLAMSystem.process_frame`), geometry only.
"""

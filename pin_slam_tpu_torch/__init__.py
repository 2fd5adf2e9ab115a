"""PIN-SLAM in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of `pin_slam_tpu` (the JAX reference package, which stays unchanged
beside it). It imports torch and numpy only, never jax and nothing of
`pin_slam_tpu`. Entry points run on `cuda` unless the caller passes
`device="cpu"`; on the CPU every kernel wrapper runs its plain PyTorch
version instead.

Every module of the JAX package has its counterpart here, at the same
relative path (the Pallas decode's is `ops/fused_decode.py`): the frame
loop (`slam.system.PinSLAMSystem`), the mesher, loop closure and PGO,
bundle adjustment, the dynamic filter, colour and semantics, the entry
point (`run.py`) and the dataset layer, the viewer (`gui/`), data
parallelism (`parallel/dp.py`) and the ROS node (`pin_slam_ros.py`).
"""

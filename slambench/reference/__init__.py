"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch modules for the front end (pyramid, FAST and its 3x3 NMS,
orientation and BRIEF, the extractor, rectified stereo matching with the
SAD refinement, rectification, camera models, Lie helpers), the per-frame
solves (the motion-only pose optimisation, the visual-inertial frame solve,
the preintegration) and the keyframe back end's window solves (local BA,
the VI window), taken when the benchmark was written. Each runs in the
dtype of its inputs (float64 for the check).

Kernel 1 is replaced by its plain form (`fast.nms3x3(fast.fast_scores(..))`).
Nothing here imports the port, JAX or the JAX package, so a later change to
the port cannot move the reference.
"""

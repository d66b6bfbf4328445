"""PyTorch/CUDA port of the MettaGrid engine and its learner.

A second package beside ``metta_tpu`` (the JAX reference). It imports
``torch``, numpy, pydantic and the standard library only: the host-side
modules it needs (config tree, map builders, env builders, the numpy
compiler) are its own copies, and the device side (env, policy in
``models/``, PPO learner in ``rl/``) is written in torch ops with
hand-written CUDA kernels under ``csrc/``. Module names mirror ``metta_tpu``
so each counterpart is easy to find.
"""

__version__ = "0.1.0"

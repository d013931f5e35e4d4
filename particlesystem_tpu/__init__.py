"""particlesystem_tpu — a JAX particle-simulation framework.

Built with JAX/XLA and a Pallas (Triton) neighbor kernel to provide the
capabilities of the reference CUDA/MPI particle system
(abraj/particleSystem on the Unicorn/pmlib runtime); it runs on NVIDIA GPUs
and, for tests, on the CPU.  See SURVEY.md for the blueprint and
BASELINE.md for the scene configurations.
"""

from .core import (Emitter, EmitterSceneConfig, GridSpec, NBodyConfig,
                   ParticleState, PlaneCollider, SphereCollider, zero_state)

__version__ = "0.1.0"

__all__ = [
    "Emitter", "EmitterSceneConfig", "GridSpec", "NBodyConfig",
    "ParticleState", "PlaneCollider", "SphereCollider", "zero_state",
    "__version__",
]

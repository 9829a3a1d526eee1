"""Oversampled polyphase filterbank analysis + inversion framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of the SKA PST DSP
Golden model (ska-telescope/ska-pst-dsp-model): oversampled PFB
channelization (SKA-Low, SKA-Mid, LowCBF firmware model), Golden FFT-based
PFB inversion, FIR prototype design, DADA test-vector generation, and a
purity/equivalence verification harness — all running as compiled XLA
programs on a GPU, sharded over device meshes for scale.
"""

__version__ = "0.1.0"

from .utils.rational import Rational  # noqa: F401
from .utils.config import Config, load_config  # noqa: F401

"""turingcodec_tpu_torch — the HEVC (H.265) encoder/decoder of
`turingcodec_tpu`, ported to PyTorch and CUDA for one NVIDIA H100.

The layout mirrors `turingcodec_tpu` module for module. The host modules
(bitstream, CABAC, headers, the decoder's host path, the encoder's search
and the native C++ core) are carried over unchanged; the encoder's
data-parallel analysis stage (`encode/device_analysis.py`) and the
decoder's reconstruction pipeline (`decode/device_pipeline.py`) run as
torch code on the card by default (`device=None` asks for the host path),
with hand-written CUDA kernels for the dense-ME sweep, motion compensation
and dequantisation + inverse transform (`csrc/`). The package imports torch
and never jax.
"""

import os as _os

# OpenBLAS worker threads spin-wait after every numpy call and steal a core
# from the native codec loops on small hosts; the codec does its own
# threading (OpenMP / wavefront rows), so pin BLAS to one thread unless the
# user overrides. Must happen before numpy first loads the BLAS library.
for _v in ("OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS",
           "NUMEXPR_NUM_THREADS"):
    _os.environ.setdefault(_v, "1")

__version__ = "0.1.0"

"""tigerbeetle_tpu_torch — the device ledger of tigerbeetle_tpu in PyTorch
and hand-written CUDA for one NVIDIA H100.

The package mirrors `tigerbeetle_tpu`'s module names (constants, types,
ops/u128, ops/hashtable, models/validate, models/ledger, state_machine) so
each module's counterpart is easy to find. It imports torch and numpy only.

Every device kernel has a plain PyTorch version in the same module: a
wrapper runs the plain version for tensors on the CPU and launches the CUDA
kernel (built from `csrc/` at first use, see `kernels/build.py`) for tensors
on a CUDA device. There is no fallback between the two.
"""

__version__ = "0.1.0"

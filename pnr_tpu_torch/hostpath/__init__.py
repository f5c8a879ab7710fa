"""Host one-shot engine: the full reconstruction pipeline in NumPy, SciPy
and the native runtime, with no device and no torch op (copies of the JAX
package's `hostpath` modules), and the Threefry port the tracer shares.
The CLI runs a single stack on it only when asked (PNR_TPU_HOST_PATH=1).
"""

from pnr_tpu_torch.hostpath.pipeline import host_reconstruction_func

__all__ = ["host_reconstruction_func"]

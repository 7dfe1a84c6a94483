"""The one place that asks which machine the program runs on.

Every choice that depends on the platform reads it here, so the program
has one answer to "where am I" and the tests can check each choice on the
CPU.  The platforms are the NVIDIA GPU (production) and the CPU (tests,
golden f64 math).
"""

import jax


def platform() -> str:
    """JAX's default backend: "gpu" or "cpu"."""
    return jax.default_backend()


def reuse_host_buffers() -> bool:
    """May a numpy buffer handed to jax.device_put be refilled later?

    On an accelerator device_put copies host memory to the device
    asynchronously, so a buffer becomes reusable once the transfer has
    finished.  The CPU client may instead alias the numpy buffer for the
    array's whole life (zero-copy), so there a buffer is never reused."""
    return platform() != "cpu"

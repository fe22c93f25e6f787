"""Suite-wide setup, applied in every worker before any test module is
imported: alias ``jax.experimental.enable_x64`` where the installed jax only
has ``jax.enable_x64`` (the reference's grid backend imports the former), and
register the ``requires_cuda`` marker.  A machine without jax (the port's CUDA
tests need none) skips the alias."""
try:
    import jax
    import jax.experimental
except ImportError:
    jax = None

if jax is not None and not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "requires_cuda: needs an NVIDIA GPU (and nvcc); skipped without one")

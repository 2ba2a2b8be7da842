"""xlab_fftbarotropic — pseudospectral barotropic / shallow-water framework.

A from-scratch JAX/XLA re-design with the full capability surface of
meteorologytoday/XLab-FFTBarotropic: spectral 2-D barotropic vorticity
dynamics, RK4, dealiasing, pressure inversion, forcing streams,
initial-condition generators, diagnostics, plus the capabilities the
reference only promised (shallow water, convergence tests, the three
README diagnostics) — designed for an accelerator with sharded
multi-device FFTs rather than translated from the serial C++/FFTW code.
The package name keeps its historical suffix.
"""

from .config import ModelConfig

__version__ = "0.1.0"
__all__ = ["ModelConfig", "adjoint"]


def __getattr__(name):
    # Lazy (PEP 562): the package root stays jax-free so jax-free entry
    # points (the forcing producer cli/vort_src_input.py) never import
    # it — `from . import adjoint` here would defeat that.
    if name == "adjoint":
        import importlib
        return importlib.import_module(".adjoint", __name__)
    raise AttributeError(name)

"""Analysis / post-processing: the L4 layer (SURVEY.md sections 2.7, 3.5).

The port's counterpart of nlsolvers_tpu/analysis/, module for module. The
diagnostics are numpy on the host, copies of the JAX package's (importing
that package imports JAX); compare and study drive the port's problems on
the card (`device="cuda"`) or, when asked, on the CPU.

energy        closed-form energy/mass functionals per equation family
conservation  per-trajectory drift metrics (the accuracy gate)
ensemble      HDF5 dataset sweeps + collective stats + NaN hunting
compare       integrator A/B (nx x dt) studies, convergence/work-precision
study         study runner CLI + the deliverable figure set (convergence /
              work-precision plots, snapshots, difference animation, CSV)
dashboards    per-directory ensemble dashboards over HDF5 datasets + CLI
spectral      modal entropy, mutual information, dispersion diagnostics
structure     SSIM vs reference frame, modal-energy grids, observed
              dispersion, local conservation, persistent homology
animate       2D/3D trajectory animation and snapshot montages
classify      trajectory classification features + dashboard
global_runs   per-run analysis across a dataset directory
isosurface    dependency-free marching tetrahedra

h5py and matplotlib are imported by the functions that use them, so this
package imports without either.
"""

from nlsolvers_tpu_torch.analysis import (compare, conservation, energy,
                                          ensemble, spectral, structure)

__all__ = ["compare", "conservation", "energy", "ensemble", "spectral",
           "structure", "study", "dashboards"]


def __getattr__(name):
    # study/dashboards import matplotlib-facing code and the pipeline
    # samplers; load them lazily so `import nlsolvers_tpu_torch.analysis`
    # stays cheap in solver-only processes.
    if name in ("study", "dashboards"):
        import importlib
        return importlib.import_module(
            f"nlsolvers_tpu_torch.analysis.{name}")
    raise AttributeError(name)

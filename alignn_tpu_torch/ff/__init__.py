"""Force-field / simulation layer (counterpart of ``alignn_tpu/ff``).

- :class:`Calculator` — energy/forces/stress for an
  :class:`~alignn_tpu_torch.chem.atoms.Atoms` from a trained model, on
  ``cuda`` unless ``device="cpu"`` is passed, with a padded bucket reused
  from call to call; :class:`iCalculator` adds a property model's
  charges, magnetic moments and named properties;
- :mod:`relax` — FIRE, L-BFGS, MDMin + cell relaxation (UnitCellFilter
  equivalent); :mod:`relax_jit` — batched FIRE on the device;
- :mod:`md` — the host-loop ensembles; :mod:`md_jit` — on-device NVE /
  Langevin chunks, each step a replayed CUDA graph on the card;
- :mod:`tasks` — E-V curve + EOS fits, vacancy formation, surface and
  interface energy; :mod:`zur` — Zur & McGill lattice matching;
- :mod:`phonons`, :mod:`phonons3` — finite-displacement force constants,
  bands, DOS, thermal properties, fc3 and Grüneisen parameters;
- :class:`~alignn_tpu_torch.ff.forcefield.ForceField` — the task runner
  of ``python -m alignn_tpu_torch.cli.ff``.

The JAX package's ``default_path`` (a download of the default model) has
no counterpart: a model directory is required.
"""

from alignn_tpu_torch.ff.calculator import (DEFAULT_IPROPS, Calculator,
                                           iCalculator)
from alignn_tpu_torch.ff.md import run_md
from alignn_tpu_torch.ff.relax import fire_relax, lbfgs_relax, relax

__all__ = ["DEFAULT_IPROPS", "Calculator", "fire_relax", "iCalculator",
           "lbfgs_relax", "relax", "run_md"]

"""openmm_agbnp_jax: JAX AGBNP/GaussVol implicit-solvent MD.

A from-scratch JAX/XLA/Pallas implementation of the capabilities of the
OpenMM AGBNP plugin (Gallicchio-Lab/openmm_agbnp_plugin): the GaussVol
surface-area model (version 0), the AGBNP1 implicit-solvent model
(version 1), analytic forces, and an on-device MD loop reproducing the
reference benchmarks.

Public entry points:
  * api.AGBNPForce / api.Context — reference-parity force API
  * models.agbnp_jax.AGBNPModel — the jitted compute path
  * md.simulation.Simulation — DMS system + AGBNP + MM forces + MD loop
  * models.oracle — float64 golden reference implementation
"""

__version__ = "0.1.0"

from .api.force import AGBNPForce, Context, NonbondedMethod  # noqa: F401
from .api.scoring import ConformerScorer  # noqa: F401

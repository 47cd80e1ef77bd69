"""Analysis tools of the port: ``ops``, the op-level accounting of dot
FLOPs, bytes, memory and collectives that the dry runs
(``launch/dryrun.py``, ``launch/aco_dryrun.py``) read, the counterpart
of ``repro.analysis.hlo``."""
from . import ops

__all__ = ["ops"]

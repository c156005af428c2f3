"""The (data, model) mesh of the port over ``torch.distributed``
(counterpart of ``tpurec/parallel``): :mod:`.mesh` (process group, mesh,
shardings), :mod:`.collectives` (the all-reduces, the expert banks'
copy, scatter and gather, and their backward rules), :mod:`.embedding`
(the row-sharded table), :mod:`.experts` (the expert banks split over
the model axis) and :mod:`.feed` (each data rank's rows of the global
batches)."""

from tpurec_torch.parallel.mesh import (Mesh, Shardings, barrier,
                                        init_distributed, make_mesh,
                                        shutdown_distributed)

__all__ = ["Mesh", "Shardings", "barrier", "init_distributed", "make_mesh",
           "shutdown_distributed"]

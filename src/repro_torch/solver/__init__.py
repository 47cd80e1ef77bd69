"""Instance-batched solver: pad, bucket and batch many TSP instances.

The PyTorch port of ``repro.solver``, drain mode:

- batch.py    pads instances to power-of-two bucket sizes with masked
              phantom cities and stacks them into a ProblemBatch (or a
              SparseBatch of candidate pages);
- engine.py   advances B colonies per call with per-instance budgets,
              patience and a done mask: on the dense fused and the sparse
              kernel routes the whole stack per engine iteration, else
              each active slot's view of the stacked state;
- service.py  a drain-the-queue request loop with throughput stats and
              supervisor/checkpoint crash recovery;
- streaming.py  continuous batching: resident slot pools on the card,
              refill surgery, priority/deadline admission, deadline
              eviction, backpressure and trace replay;
- placement.py  the instance axis sharded over the positions of a
              ``launch.mesh.Mesh`` (``run_batch(mesh=)``), phantom-slot
              padding, device labels.

The program cache is not ported yet (ROADMAP queue 1 item 15).
"""
from .batch import (ProblemBatch, SparseBatch, bucket_ladder,  # noqa: F401
                    bucket_size, make_batch, make_sparse_batch,
                    padded_problem)
from .engine import (collect, init_sparse_states, init_state,  # noqa: F401
                     init_states, run_batch, solve_instances)
from .service import SolveRequest, SolveResult, SolverService  # noqa: F401
from .streaming import (AdmissionError, StreamingPool,  # noqa: F401
                        StreamingSolverService, StreamRequest, TraceItem,
                        make_poisson_trace, replay_trace)

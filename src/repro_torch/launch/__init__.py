"""Entry points of the port: ``solve_serve``, the solver's serving CLI
(the port of ``repro.launch.solve_serve``), ``serve`` and ``train``, the
LM's server and trainer, ``steps``, their step factories, and ``mesh``,
the device meshes that the multi-device routes run over."""

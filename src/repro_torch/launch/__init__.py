"""Entry points of the port: ``solve_serve``, the serving CLI (the port of
``repro.launch.solve_serve``), and ``mesh``, the device meshes that the
multi-device routes run over."""

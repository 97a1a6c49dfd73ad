"""Multi-device layer: the mesh and its sharding rules (``mesh``), the
collectives with their gradients (``comm``), process-group launching
(``launch``), the time-sharded forward and train step (``time_shard``) and
the time-sharded Griffin-Lim (``gl_shard``). Submodules are imported where
they are used: ``models`` imports ``comm`` and ``mesh``, and ``time_shard``
imports ``models``."""

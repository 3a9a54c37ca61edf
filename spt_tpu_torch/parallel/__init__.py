"""Distribution over ``torch.distributed``: the render mesh (``mesh``), the
sample-sharded wavefront and its data-parallel gradient
(``wavefront_sharded``), the DP gradient step (``sharding``) and the
primitive-sharded wavefront (``wavefront_prim``, with K8 and K7 reading its
merged shadow verdict).  ``tools/dist_worker.py`` spawns ranks that run
them.
"""

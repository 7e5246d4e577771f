"""The port's launch layer: ``mesh`` (``MeshSpec``, ``init_world``: the
``torch.distributed`` meshes the ``*_sharded`` entry points run on),
``serve_coloring`` (the continuous-batching ``ColoringService``, one device
or a mesh) and ``serve_harness`` (its scripted fake-clock event loop)."""

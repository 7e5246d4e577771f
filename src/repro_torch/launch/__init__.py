"""The port's launch layer: ``mesh`` (``MeshSpec``, ``init_world``: the
``torch.distributed`` meshes the ``*_sharded`` entry points run on),
``serve_coloring`` (the continuous-batching ``ColoringService``, one device
or a mesh), ``serve_harness`` (its scripted fake-clock event loop),
``serve`` (the LM scaffold's batched prefill + greedy decode), ``steps``
(the LM's train, prefill and decode steps) and ``train`` (the LM's
training launcher)."""

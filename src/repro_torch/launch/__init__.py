"""The port's serving entry points: ``serve_coloring`` (the
continuous-batching ``ColoringService``) and ``serve_harness`` (its
scripted fake-clock event loop)."""

"""Pipelines (port of gaustudio_tpu/pipelines): the vanilla, 2DGS and Scaffold trainers,
mesh and point extraction, and the mesh initializers."""

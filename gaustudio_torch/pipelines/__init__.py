"""Pipelines (port of gaustudio_tpu/pipelines): the vanilla and 2DGS trainers and mesh
extraction."""

"""Training pipelines (port of gaustudio_tpu/pipelines; the vanilla trainer)."""

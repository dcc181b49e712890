"""Utilities: logging setup and the YAML config reader (counterparts of
`matten_tpu/utils/`)."""

"""Host-side data layer: structures, periodic graphs, batching, transforms
(numpy; counterparts of `matten_tpu/data/`)."""

"""Dict-passing torch modules of the TFN model (counterparts of
`matten_tpu/nn/`)."""

"""io layer of meshflow_tpu_torch."""

"""metrics layer of meshflow_tpu_torch."""

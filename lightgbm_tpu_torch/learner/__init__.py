"""Tree learners of lightgbm_tpu_torch (the serial grower)."""

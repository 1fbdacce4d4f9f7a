"""Data-file input of lightgbm_tpu_torch (`parser.py`)."""

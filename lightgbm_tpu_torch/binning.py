"""Missing-value types of a feature's bin mapper.

Only the constants the prediction walk reads (the same values as
`lightgbm_tpu/binning.py` and the reference's MissingType,
bin.h:23-27); the bin mappers themselves arrive with training.
"""
MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

"""The fields of a state commitment (the counterpart of the `FP_FIELDS`
tuple of `tigerbeetle_tpu/federation/commitment.py`).

A replica folds these state-fingerprint fields into its checkpoint
commitment chain; the dual-commit follower compares the device twin's
fingerprint with the host engine's on exactly these fields.
"""

FP_FIELDS = (
    "accounts_fp",
    "transfers_fp",
    "accounts",
    "transfers",
    "commit_timestamp",
)

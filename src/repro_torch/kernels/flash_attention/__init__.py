"""Flash attention on Hopper: decode (split-KV) and causal prefill."""
from .kernel import (
    LAUNCHES,
    decode_splits,
    flash_decode,
    flash_prefill_causal,
    reset_launch_counts,
)
from .ops import attention_decode, attention_prefill_causal
from .ref import decode_ref, prefill_causal_ref, repeat_kv

__all__ = ["LAUNCHES", "attention_decode", "attention_prefill_causal", "decode_ref",
           "decode_splits", "flash_decode", "flash_prefill_causal",
           "prefill_causal_ref", "repeat_kv", "reset_launch_counts"]

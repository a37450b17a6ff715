"""A/B-test router: a copy of `sparrowrecsys_tpu/serving/ab.py`
(parity with `online/util/ABTest.java`).

Bucketing uses Java's `String.hashCode()` semantics exactly
(s[0]*31^(n-1) + ... over UTF-16 units, 32-bit signed overflow), so a
given userId lands in the same bucket as in the reference:
hash % 5 == 0 -> "emb" (bucket A), == 1 -> "nerualcf" (bucket B — the
reference's load-bearing typo, ABTest.java:14), else default "emb".
Note Java's % keeps the sign of the dividend, so negative hashes fall
through to the default branch — preserved.
"""

from __future__ import annotations

TRAFFIC_SPLIT_NUMBER = 5
BUCKET_A_MODEL = "emb"
BUCKET_B_MODEL = "nerualcf"  # sic — reference typo, ABTest.java:14
DEFAULT_MODEL = "emb"


def java_string_hashcode(s: str) -> int:
    """Java String.hashCode with 32-bit signed wraparound."""
    h = 0
    for ch in s:
        h = (31 * h + ord(ch)) & 0xFFFFFFFF
    return h - 0x100000000 if h >= 0x80000000 else h


def get_config_by_user_id(user_id: str) -> str:
    if not user_id:
        return DEFAULT_MODEL
    # Java % truncates toward zero: negative hash % 5 is in (-4..0].
    h = java_string_hashcode(user_id)
    r = h - int(h / TRAFFIC_SPLIT_NUMBER) * TRAFFIC_SPLIT_NUMBER
    if r == 0:
        return BUCKET_A_MODEL
    if r == 1:
        return BUCKET_B_MODEL
    return DEFAULT_MODEL

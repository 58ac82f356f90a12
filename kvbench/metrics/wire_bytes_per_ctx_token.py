"""Bytes the transport counted over the window (``total_bytes``), per
context position shared (BOS included)."""


def read(rec):
    if not rec.wire_bytes or not rec.prefix_tokens:
        return None
    return rec.wire_bytes / rec.prefix_tokens

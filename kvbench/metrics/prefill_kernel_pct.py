"""Share of the traced wave's prefill attention calls (self-attention
over more than one new token) that ran the prefill kernel: the program's
``prefill.attn_kernel`` counter over it plus ``prefill.attn_plain``, in
percent."""
from kvbench import spans


def read(rec):
    kernel = spans.counter(rec, "prefill.attn_kernel")
    plain = spans.counter(rec, "prefill.attn_plain")
    if kernel is None or plain is None or not kernel + plain:
        return None
    return 100.0 * kernel / (kernel + plain)

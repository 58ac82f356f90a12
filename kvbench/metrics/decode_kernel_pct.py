"""Share of the traced wave's one-token self-attention calls that ran K1
(the ragged decode kernel): the program's ``decode.attn_kernel`` counter
over it plus ``decode.attn_plain``, in percent. K1 takes layers without a
window, so a model whose layers are windowed 3 in 4 reads 25%."""
from kvbench import spans


def read(rec):
    kernel = spans.counter(rec, "decode.attn_kernel")
    plain = spans.counter(rec, "decode.attn_plain")
    if kernel is None or plain is None or not kernel + plain:
        return None
    return 100.0 * kernel / (kernel + plain)

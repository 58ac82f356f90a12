"""Answer tokens completed over the whole window, every wave in full,
over the window's seconds (to the end of the last wave started). The
tokens are counted here, from the completions the harness received."""


def read(rec):
    tokens = sum(len(c.tokens) for w in rec.waves
                 for c in w.completions.values())
    return tokens / rec.window_s if tokens else None

#!/usr/bin/env python3
"""chip_smoke.py's RWKV6 state-sharing phase from two checkouts in turns
(parent, change, change, parent) on one card, each run its own process:

    mkdir -p build/parent_tree && git archive HEAD~1 | tar -x -C build/parent_tree
    mkdir -p build/change_tree && git archive HEAD | tar -x -C build/change_tree
    python3 tools/rwkv6_phase_ab.py build/parent_tree build/change_tree

Each run builds K4 in its checkout and prints, as JSON lines, the in-memory
round's stage times (host clock: sender and receiver prefill, a decode
step, tokens/s) and the phase's seconds with K4's device ms at T 2049."""
import json
import subprocess
import sys

CODE = r'''
import sys, torch
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.kernels import _build
from repro_torch.launch import pairs
_build.load_all(("rwkv_scan",))
dev = torch.device("cuda")
scratch = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
cs.phase_rwkv6_state_sharing(dev, cs.smi_line(), lambda: scratch.zero_(),
                             pairs.pair_tokenizer())
'''


def main(parent, change):
    for name, tree in (("parent", parent), ("change", change),
                       ("change", change), ("parent", parent)):
        out = subprocess.run([sys.executable, "-c", CODE], cwd=tree,
                             capture_output=True, text=True)
        if out.returncode:
            print(name, "rc", out.returncode, out.stderr[-2000:], flush=True)
            return out.returncode
        for line in out.stdout.splitlines():
            if not line.startswith("{"):
                continue
            d = json.loads(line)
            if d.get("transport") == "inmemory":
                print(json.dumps({"tree": name, **{k: d[k] for k in (
                    "sender_prefill_ms", "receiver_prefill_ms",
                    "decode_step_ms", "tokens_per_s", "generate_ms",
                    "share_ms")}}), flush=True)
            elif d.get("phase") == "state_sharing_rwkv6":
                print(json.dumps({"tree": name, "phase_s": d["seconds"],
                                  "k4_T2049": d["k4_device_ms_T2049"]}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))

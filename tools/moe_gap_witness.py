"""Why a served token of an MoE cell lies far below the float32
reference's best: a witness for the check's ``gap_max`` readings.

For each seed the program serves one wave of the cell as
``kvbench.readings`` does, and the check's sampled requests are read
four ways against the float32 reference, on the same prompts and served
tokens: the program's served tokens; the float8 control's first choices;
and the first choices of two bf16 references, the family's float32
reference with every matrix product taken in bf16 (operands and result
rounded to bf16, float32 accumulation, the router fed the bf16-rounded
hidden state as the program feeds it), and the same with the residual
stream, the norms' outputs, q / k / v, the attention output and the
embedding rounded to bf16 as well, as the program keeps them
("bf16_all"). The bf16 references share no code with the program: where
they read gaps of the program's size, those gaps are bf16 arithmetic on
this model and these weights, not a fault of the program.

At the program's worst token the float32 and bf16 references' routing is
compared layer by layer (the experts each puts in its top k, and the
float32 margin between its k-th and (k+1)-th probability), and each bf16
reference is run again with its routing forced to the float32
reference's choices everywhere: if that closes its gaps, they come from
routing flips.

Each side's per-token gaps are summarised (max, p99, p90, mean, median,
the per-request maxima and their median), so that a candidate check
number can be read on the program and the control alike.

    python3 tools/moe_gap_witness.py --workload mellum2-12b.doc_qa_8k \\
        --seeds 1 2 3 [--out witness.jsonl]

Needs a CUDA card (the cell at its own size). One JSON line per seed.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def witness_class(base):
    """The family's reference with three switches: ``bf16`` (every matrix
    product in bf16), ``bf16_all`` (that, and the residual stream, the
    norms' outputs, q / k / v, the attention output and the embedding
    rounded to bf16) and routing hooks, ``record`` (a dict filled with
    each layer's router probabilities, keyed by (role, layer)) and
    ``force`` (such a dict of top-k indices to route by instead)."""

    class Witness(base):
        def __init__(self, *a, bf16: bool = False, bf16_all: bool = False,
                     role: str = "", **kw):
            super().__init__(*a, **kw)
            self.bf16, self.all, self.role = bf16 or bf16_all, bf16_all, role
            self.record: Optional[Dict] = None
            self.force: Optional[Dict] = None
            self._layer = -1

        def _r(self, t):
            return t.to(torch.bfloat16).float() if self.all else t

        def embed(self, tokens):
            return self._r(super().embed(tokens))

        def norm(self, x, w):
            return self._r(super().norm(x, w))

        def qkv(self, w, x, pos):
            return tuple(self._r(t) for t in super().qkv(w, x, pos))

        def attend_at(self, *a, **kw):
            out, m = super().attend_at(*a, **kw)
            return self._r(out), m

        def _block(self, w, x, pos, prefix=None, mass=False):
            """The family's block, each residual sum rounded (bf16_all)."""
            if not self.all:
                return super()._block(w, x, pos, prefix, mass)
            q, k, v = self.qkv(w, self.norm(x, w["ln1"]), pos)
            kk, vv, kp, n = k, v, pos, 0
            if prefix is not None:
                pk, pv = prefix
                n = pk.shape[0]
                kk, vv = torch.cat([pk, k]), torch.cat([pv, v])
                kp = torch.cat([torch.arange(n, device=pos.device), pos])
            out, m = self.attend_at(q, kk, vv, pos, kp, n, w["window"], mass)
            x = self._r(x + self.mm(out, w["wo"]))
            y = self._r(self.ffn(w, self.norm(x, w["ln2"])))
            return self._r(x + y), k, v, m

        def layer(self, i):
            self._layer = i
            return super().layer(i)

        def mm(self, x, w):
            if not self.bf16:
                return super().mm(x, w)
            return (x.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()

        def ffn(self, w, x):
            key = (self.role, self._layer)
            if self.record is None and self.force is None:
                if self.bf16:
                    x = x.to(torch.bfloat16).float()
                return super().ffn(w, x)
            if self.bf16:
                x = x.to(torch.bfloat16).float()
            probs = torch.softmax(x @ w["router"], dim=-1)
            if self.record is not None:
                self.record[key] = probs.detach()
            k = self.k
            if self.force is not None and key in self.force:
                idx = self.force[key]
            else:
                idx = torch.sort(probs, dim=-1, descending=True,
                                 stable=True).indices[:, :k]
            gates = probs.gather(1, idx)
            gates = gates / gates.sum(-1, keepdim=True)
            out = torch.zeros_like(x)
            for e in range(w["router"].shape[1]):
                rows, slot = (idx == e).nonzero(as_tuple=True)
                if rows.numel() == 0:
                    continue
                xe = x[rows]
                h = torch.nn.functional.silu(self.mm(xe, w["w_gate"][e])) \
                    * self.mm(xe, w["w_up"][e])
                out.index_add_(0, rows, self.mm(h, w["w_down"][e])
                               * gates[rows, slot, None])
            return out

    return Witness


def summary(tok: List[np.ndarray]) -> Dict:
    """A side's per-token gaps (one array a request), summarised."""
    allg = np.concatenate(tok) if tok else np.zeros(0)
    per = [float(g.max()) for g in tok]
    return {"max": float(allg.max()), "p99": float(np.percentile(allg, 99)),
            "p90": float(np.percentile(allg, 90)),
            "mean": float(allg.mean()), "median": float(np.median(allg)),
            "nonzero_share": float((allg > 0).mean()),
            "request_max": per,
            "request_max_median": float(np.median(per))}


def routing_at(rec32: Dict, recb: Dict, row: int, k: int) -> List[Dict]:
    """Each receiver layer's routing at one row: the float32 and bf16
    references' top-k sets, the experts that differ, and the float32
    probability margin between the k-th and (k+1)-th expert."""
    out = []
    for key in sorted(k_ for k_ in rec32 if k_[0] == "receiver"):
        p32, pb = rec32[key][row], recb[key][row]
        s32 = torch.sort(p32, descending=True, stable=True)
        sb = torch.sort(pb, descending=True, stable=True)
        a = set(s32.indices[:k].tolist())
        b = set(sb.indices[:k].tolist())
        out.append({"layer": key[1], "flipped": sorted(a ^ b),
                    "margin_f32": float(s32.values[k - 1] - s32.values[k]),
                    "kth_prob_f32": float(s32.values[k - 1])})
    return out


def flips(rec32: Dict, recb: Dict, k: int) -> Dict:
    """Over every layer and row of both roles: the (layer, row) pairs
    whose top-k sets differ between the two references, and the largest
    float32 margin between the k-th and (k+1)-th probability among
    them (a near-tie if small)."""
    n, worst = 0, 0.0
    for key, p32 in rec32.items():
        s32 = torch.sort(p32, dim=-1, descending=True, stable=True)
        a = s32.indices[:, :k].sort(-1).values
        b = top_idx({key: recb[key]}, k)[key].sort(-1).values
        diff = (a != b).any(-1)
        n += int(diff.sum())
        if bool(diff.any()):
            margin = s32.values[:, k - 1] - s32.values[:, k]
            worst = max(worst, float(margin[diff].max()))
    rows = sum(p.shape[0] for p in rec32.values())
    return {"pairs_flipped": n, "pairs": rows,
            "largest_flipped_margin_f32": worst}


def top_idx(rec: Dict, k: int) -> Dict:
    return {key: torch.sort(p, dim=-1, descending=True,
                            stable=True).indices[:, :k]
            for key, p in rec.items()}


def witness(cell, seed: int, dev, sample_tokens: Optional[int] = None
            ) -> Dict:
    """One seed's reading (see the module's docstring)."""
    from kvbench import check, generator, reference as ref
    from kvbench.harness import BOS, Bench, make_param_sets
    fam = cell.family
    W = witness_class(fam.Reference)
    t0 = time.perf_counter()
    params = make_param_sets(cell, seed, dev)
    bench = Bench(cell, seed, dev, params)
    waves = [bench.run_wave(generator.wave(cell.mix, seed, 0,
                                           bench.cfg.vocab_size))]
    served = bench.served(waves)
    layers, wire = list(bench.layers), bench.wire
    bench.release()
    del bench
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    picked = check.sample(served, seed,
                          sample_tokens or cell.spec["sample_tokens"])
    m, mlp = cell.model, cell.mlp
    r32 = [W(m, mlp, params[i], role=r)
           for i, r in enumerate(("sender", "receiver"))]
    r8 = [W(m, mlp, params[i], mode="fp8", role=r)
          for i, r in enumerate(("sender", "receiver"))]
    rb = [W(m, mlp, params[i], bf16=True, role=r)
          for i, r in enumerate(("sender", "receiver"))]
    ra = [W(m, mlp, params[i], bf16_all=True, role=r)
          for i, r in enumerate(("sender", "receiver"))]

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

    def logits(refs, blk):
        return ref.served_logits(
            refs[0], refs[1], [t(s.context) for s in blk],
            [t(s.query) for s in blk], [t(s.tokens) for s in blk], layers,
            wire, BOS)

    prog, ctl, b16, ball, agree, agree_all = [], [], [], [], [], []
    for a in range(0, len(picked), 4):
        blk = picked[a:a + 4]
        exact = logits(r32, blk)
        low8 = logits(r8, blk)
        lowb = logits(rb, blk)
        lowa = logits(ra, blk)
        for s, e, l8, lb, la in zip(blk, exact, low8, lowb, lowa):
            served_t = t(s.tokens)
            prog.append(ref.gaps(e, served_t).cpu().numpy())
            ctl.append(ref.gaps(e, l8.argmax(-1)).cpu().numpy())
            b16.append(ref.gaps(e, lb.argmax(-1)).cpu().numpy())
            ball.append(ref.gaps(e, la.argmax(-1)).cpu().numpy())
            agree.append((lb.argmax(-1) == served_t).cpu().numpy())
            agree_all.append((la.argmax(-1) == served_t).cpu().numpy())
        del exact, low8, lowb, lowa
    # the program's worst token
    r_w = int(np.argmax([g.max() for g in prog]))
    t_w = int(np.argmax(prog[r_w]))
    blk = [picked[r_w]]
    for refs in (r32, rb, ra):
        for x in refs:
            x.record = {}
    e32 = logits(r32, blk)[0]
    logits(rb, blk)
    logits(ra, blk)
    rec32 = {**r32[0].record, **r32[1].record}
    recb = {**rb[0].record, **rb[1].record}
    reca = {**ra[0].record, **ra[1].record}
    n_ans = len(picked[r_w].tokens)
    n_rows = len(picked[r_w].query) + n_ans - 1
    row = n_rows - n_ans + t_w
    k = m["num_experts_per_tok"]
    routes = routing_at(rec32, recb, row, k)
    force = top_idx(rec32, k)
    for x in (*r32, *rb, *ra):
        x.record = None
    for x in (*rb, *ra):
        x.force = force
    ebf = logits(rb, blk)[0]
    eaf = logits(ra, blk)[0]
    for x in (*rb, *ra):
        x.force = None
    served_w = int(picked[r_w].tokens[t_w])
    top2 = torch.topk(e32[t_w], 2)
    worst = {
        "request": r_w, "position": t_w, "answer_len": n_ans,
        "program_gap": float(prog[r_w][t_w]),
        "served_token": served_w,
        "served_is_f32_runner_up": int(top2.indices[1]) == served_w,
        "f32_top2_margin": float(top2.values[0] - top2.values[1]),
        "bf16_ref_gap": float(b16[r_w][t_w]),
        "bf16_ref_picks_served": bool(agree[r_w][t_w]),
        "bf16_ref_forced_gap": float(ref.gaps(
            e32[t_w:t_w + 1], ebf[t_w:t_w + 1].argmax(-1))[0]),
        "bf16_ref_forced_request_max": float(ref.gaps(
            e32, ebf.argmax(-1)).max()),
        "bf16_all_ref_gap": float(ball[r_w][t_w]),
        "bf16_all_ref_picks_served": bool(agree_all[r_w][t_w]),
        "bf16_all_ref_forced_gap": float(ref.gaps(
            e32[t_w:t_w + 1], eaf[t_w:t_w + 1].argmax(-1))[0]),
        "bf16_all_ref_forced_request_max": float(ref.gaps(
            e32, eaf.argmax(-1)).max()),
        "bf16_all_request_flips": flips(rec32, reca, k),
        "layers_flipped": [r["layer"] for r in routes if r["flipped"]],
        "request_flips": flips(rec32, recb, k),
        "min_margin_f32": min(r["margin_f32"] for r in routes),
        "min_margin_f32_flipped": min(
            (r["margin_f32"] for r in routes if r["flipped"]), default=None),
        "routing": routes}
    del e32, ebf, eaf, r32, r8, rb, ra, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"cell": cell.name, "seed": seed,
            "sampled_requests": len(picked),
            "sampled_tokens": int(sum(len(g) for g in prog)),
            "program": summary(prog), "control_fp8": summary(ctl),
            "bf16_reference": summary(b16),
            "bf16_all_reference": summary(ball),
            "bf16_ref_agrees_with_program": float(
                np.concatenate(agree).mean()),
            "bf16_all_ref_agrees_with_program": float(
                np.concatenate(agree_all).mean()),
            "worst": worst,
            "token_gaps": {"program": [g.tolist() for g in prog],
                           "control_fp8": [g.tolist() for g in ctl],
                           "bf16_reference": [g.tolist() for g in b16],
                           "bf16_all_reference": [g.tolist() for g in ball]},
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 tools/moe_gap_witness.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from kvbench.harness import load_cell, load_json
    if not torch.cuda.is_available():
        print("moe_gap_witness needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = load_cell(load_json(ROOT / "BENCHMARK.json"), args.workload)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        line = witness(cell, seed, dev)
        short = {k: v for k, v in line.items() if k != "token_gaps"}
        print(json.dumps(short), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What decides ``correct``: the served tokens against the reference.

Once the window has closed and the program's state is freed, a sample
of the window's finished requests, drawn from the seed with the longest
of them in it, is checked:
- the ids the engine produced for the request (serve.Tee) are as many
  as it asked for, and the tokens the client received are those ids;
- the reference runs once over each prompt with its served tokens, and
  the gap by which a served token's logit lies below the reference's
  best logit at its position, averaged over every position checked,
  must stay within the cell's limit (``cells/<cell>.json``
  ``correct.mean_gap``). Every request is greedy (temperature 0), so the
  served token is the program's argmax.

The mean and not the widest gap is compared: the widest swings from
seed to seed with the one position where bfloat16 rounding moves the
logits most, and at the cells' sizes the control reads less than three
times the widest that sound runs read, while its mean reads ten times
theirs (PERF.md, "Correctness"). The widest is printed beside it.
"""

import random
from typing import Dict, List, Optional

import torch

from h100_bench.reference import Reference, gaps


def token_text(token_id: int) -> str:
    """The text a byte-level tokenizer's logprobs give an id: a byte's
    character (one byte above 127 alone is not UTF-8), else its special
    name."""
    if 0 <= token_id < 256:
        return bytes([token_id]).decode("utf-8", errors="replace")
    return {256: "<bos>", 257: "<eos>", 258: "<pad>"}.get(
        token_id, f"<unk:{token_id}>")


def sample(run: Dict, seed: int, tokens: int, requests: int) -> List[Dict]:
    """Of the requests that finished from the window's opening on, the
    longest (prompt plus output), then others in an order the seed
    draws, until ``tokens`` served tokens or ``requests`` requests."""
    done = [r for r in run["records"] if r["finished"] and not r["error"]
            and r["times"] and r["times"][-1] >= run["open"]]
    if not done:
        return []
    done.sort(key=lambda r: r["i"])
    longest = max(done, key=lambda r: (r["prompt_len"] + r["max_tokens"],
                                       -r["i"]))
    rest = [r for r in done if r is not longest]
    random.Random(seed ^ 0x5A17).shuffle(rest)
    picked, n = [longest], longest["max_tokens"]
    for r in rest:
        if n >= tokens or len(picked) >= requests:
            break
        picked.append(r)
        n += r["max_tokens"]
    return picked


def stream_faults(recs: List[Dict], served: Dict[str, List[int]]) -> Dict:
    short = mismatched = 0
    for r in recs:
        ids = served.get(r["key"], [])
        if len(ids) != r["max_tokens"]:
            short += 1
        if [token_text(i) for i in ids] != r["tokens"]:
            mismatched += 1
    return {"short_outputs": short, "stream_mismatches": mismatched}


def sequences(recs: List[Dict], prompts: List[List[int]],
              served: Dict[str, List[int]]):
    """(token sequences, first positions, served tokens) of the sampled
    requests: each prompt with its served tokens but the last, whose
    logits at the prompt's last position on score the served ones."""
    seqs, firsts, targets = [], [], []
    for r, prompt in zip(recs, prompts):
        ids = served[r["key"]]
        seqs.append(torch.tensor(prompt + ids[:-1], dtype=torch.long))
        firsts.append(len(prompt) - 1)
        targets.append(torch.tensor(ids, dtype=torch.long))
    return seqs, firsts, targets


def _verdict(recs: List[Dict], faults: Dict,
             g: Optional[torch.Tensor], rule: Dict) -> Dict:
    checks = {
        "requests_checked": {"value": len(recs), "limit": 1, "rule": ">="},
        "tokens_checked": {"value": sum(r["max_tokens"] for r in recs),
                           "limit": 1, "rule": ">="},
        "short_outputs": {"value": faults["short_outputs"], "limit": 0,
                          "rule": "<="},
        "stream_mismatches": {"value": faults["stream_mismatches"],
                              "limit": 0, "rule": "<="},
        "mean_gap": {"value": None if g is None else float(g.mean()),
                     "limit": rule["mean_gap"], "rule": "<="},
    }
    correct = all(
        c["value"] is not None
        and (c["value"] <= c["limit"] if c["rule"] == "<="
             else c["value"] >= c["limit"])
        for c in checks.values())
    return {"correct": correct, "checks": checks,
            "widest_gap": None if g is None else float(g.max())}


def check(run: Dict, plan: Dict, served: Dict[str, List[int]], cfg: Dict,
          cell: Dict, seed: int, device,
          control: Optional[str] = None) -> Dict:
    """{"correct": bool, "checks": {name: {"value", "limit", "rule"}},
    "widest_gap", "sample": the requests compared with the reference}.

    With ``control`` (a precision of reference.py), the verdict also
    holds, under "control", the same check of the control put in the
    program's place: at each position of the same prompts and served
    tokens, the token the control puts first is scored instead of the
    served one. It has to come out not correct."""
    rule = cell["correct"]
    recs = sample(run, seed, rule["tokens"], rule["requests"])
    faults = stream_faults(recs, served)
    ok_streams = [r for r in recs if len(served.get(r["key"], []))
                  == r["max_tokens"]]
    seqs, firsts, targets = sequences(
        ok_streams, [plan["requests"][r["i"]]["prompt"]
                     for r in ok_streams], served)
    ref = Reference(cfg, seed, device).logits(seqs, firsts) if seqs else []

    def scored(tokens):
        return (torch.cat([gaps(lg, t) for lg, t in zip(ref, tokens)])
                if ref else None)
    verdict = _verdict(recs, faults, scored(targets), rule)
    verdict["sample"] = ok_streams
    if control is not None:
        picks = [lg.argmax(-1) for lg in Reference(
            cfg, seed, device, control).logits(seqs, firsts)] if seqs else []
        verdict["control"] = dict(precision=control, **_verdict(
            recs, faults, scored(picks), rule))
    return verdict

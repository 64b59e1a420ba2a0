"""The window's arithmetic, from the client's records (client.py).

A request belongs to the window when it was due inside it. ``percentile`` is a copy of the port's
``loadgen/report.py`` nearest-rank percentile.
"""

from typing import Dict, List, Sequence


def percentile(values: Sequence[float], p: float) -> float:
    """Nearest-rank percentile on an unsorted sequence; 0.0 if empty."""
    if not values:
        return 0.0
    s = sorted(values)
    idx = min(len(s) - 1, max(0, int(round(p / 100.0 * (len(s) - 1)))))
    return s[idx]


def window_requests(run: Dict) -> List[Dict]:
    return [r for r in run["records"] if r["in_window"]]


def output_tokens_in_window(run: Dict) -> int:
    """Tokens the clients received between the window's open and close,
    of any request."""
    a, b = run["open"], run["close"]
    return sum(1 for r in run["records"] for t in r["times"] if a <= t <= b)


def ttfts_s(run: Dict) -> List[float]:
    """Each window request's time from due to its first token.
    One that never returned a token counts with the time it waited until
    the generator stopped, and at least until the window closed."""
    out = []
    for r in window_requests(run):
        if r["times"]:
            out.append(r["times"][0] - r["due"])
        else:
            out.append(max(run["end"], run["close"]) - r["due"])
    return out


def tpots_s(run: Dict) -> List[float]:
    """(last token - first token) / (tokens - 1) of each window request
    that returned two tokens or more."""
    return [(r["times"][-1] - r["times"][0]) / (len(r["times"]) - 1)
            for r in window_requests(run) if len(r["times"]) >= 2]


def failed(run: Dict) -> int:
    """Window requests that failed: an error status, or a stream that
    ended without its finish. One still running when the generator
    stopped is late, not failed: its latency counts the wait."""
    return sum(1 for r in window_requests(run) if r["error"])

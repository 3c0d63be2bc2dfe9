# A copy of eco_tpu/tools/logparse.py (no framework code); tests/test_torch_cli.py holds it to the original.
"""Training-log parsing + curve plotting -- tools/extra parity.

The reference ships ``parse_log.sh`` / ``parse_log.py`` (log -> two tables:
``<log>.train`` with ``#Iters Seconds TrainingLoss LearningRate`` and
``<log>.test`` with ``#Iters Seconds TestAccuracy TestLoss``) plus
``plot_training_log.py.example`` (matplotlib charts of any field vs
Iters/Seconds) -- reference ``caffe_3d/tools/extra/parse_log.sh:1-47`` and
``plot_training_log.py.example``.  This module does the same job for the
Trainer's log format:

    Iteration 120, loss = 1.2345 (lr=1.00e-03, |g|=12.34, 4.56s)
    Test: accuracy = 0.9000, loss = 0.4321

Differences by design: the Trainer prints elapsed seconds PER display
interval (the reference timestamps every glog line), so Seconds is the
cumulative sum of those intervals; test rows carry whatever metric tops the
graph declares (top-k accuracies, losses) rather than a fixed #0/#1 pair.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

_TRAIN_RE = re.compile(
    r"Iteration (\d+), loss = ([-.\deE+naif]+) "
    r"\(lr=([-.\deE+]+), \|g\|=([-.\deE+naif]+), ([.\d]+)s\)"
)
_TEST_RE = re.compile(r"Test: (.+)$")
_KV_RE = re.compile(r"(\S+) = ([-.\deE+naif]+)")


@dataclass
class ParsedLog:
    """Train/test curves extracted from a Trainer log."""

    train: dict = field(default_factory=dict)  # column -> list
    test: dict = field(default_factory=dict)   # column -> list

    def train_table(self) -> str:
        """The reference's ``<log>.train`` table text
        (``#Iters Seconds TrainingLoss LearningRate``)."""
        lines = ["#Iters Seconds TrainingLoss LearningRate"]
        for i, s, l, lr in zip(
            self.train.get("iters", ()), self.train.get("seconds", ()),
            self.train.get("loss", ()), self.train.get("lr", ()),
        ):
            lines.append(f"{i:.0f} {s:.2f} {l:g} {lr:g}")
        return "\n".join(lines) + "\n"

    def test_table(self) -> str:
        """The reference's ``<log>.test`` table
        (``#Iters Seconds <metric columns...>``)."""
        metrics = [k for k in self.test if k not in ("iters", "seconds")]
        lines = ["#Iters Seconds " + " ".join(
            "".join(w.capitalize() for w in ("test_" + m).split("_"))
            for m in metrics
        )]
        for row in zip(
            self.test.get("iters", ()), self.test.get("seconds", ()),
            *[self.test[m] for m in metrics],
        ):
            lines.append(" ".join(
                f"{v:.0f}" if j == 0 else f"{v:g}"
                for j, v in enumerate(row)
            ))
        return "\n".join(lines) + "\n"


def parse_log(text: str) -> ParsedLog:
    """Parse Trainer log text into train/test curve columns.

    Train rows: iters / seconds (cumulative) / loss (smoothed window, as
    displayed) / lr.  Test rows: iters (the nearest preceding train
    iteration, the reference's association rule) / seconds / one column per
    metric top.
    """
    out = ParsedLog(
        train={"iters": [], "seconds": [], "loss": [], "lr": []},
        test={"iters": [], "seconds": []},
    )
    elapsed = 0.0
    last_iter = 0
    for line in text.splitlines():
        m = _TRAIN_RE.search(line)
        if m:
            it, loss, lr, gnorm, dt = m.groups()
            elapsed += float(dt)
            last_iter = int(it)
            out.train["iters"].append(last_iter)
            out.train["seconds"].append(elapsed)
            out.train["loss"].append(float(loss))
            out.train["lr"].append(float(lr))
            continue
        m = _TEST_RE.search(line)
        if m:
            kvs = _KV_RE.findall(m.group(1))
            if not kvs:
                continue
            out.test["iters"].append(last_iter)
            out.test["seconds"].append(elapsed)
            n = len(out.test["iters"])
            for k, v in kvs:
                col = out.test.setdefault(k, [])
                # metric first seen mid-log (e.g. a resumed run that added
                # a top): backfill with nan so columns stay row-aligned
                col.extend([float("nan")] * (n - 1 - len(col)))
                col.append(float(v))
    # metric absent from the last rows: pad to full length for zip()
    n = len(out.test["iters"])
    for col in out.test.values():
        col.extend([float("nan")] * (n - len(col)))
    return out


def write_tables(log_path: str, parsed: ParsedLog | None = None,
                 ) -> tuple[str, str]:
    """Emit ``<log>.train`` / ``<log>.test`` next to the log
    (parse_log.sh's output contract).  Returns the two paths."""
    if parsed is None:
        with open(log_path) as f:
            parsed = parse_log(f.read())
    tr, te = log_path + ".train", log_path + ".test"
    with open(tr, "w") as f:
        f.write(parsed.train_table())
    with open(te, "w") as f:
        f.write(parsed.test_table())
    return tr, te


def plot_curves(parsed: ParsedLog, output: str, *, x_axis: str = "iters",
                fields: tuple = ("loss", "lr", "accuracy")) -> str:
    """Render training curves to ``output`` (png/svg/pdf by extension) --
    plot_training_log.py.example parity, one figure with a twin LR axis.

    ``fields``: any of the train columns (loss, lr) plus any test metric
    name; unknown names are skipped (a log with no test passes has no
    accuracy column).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    x_tr = parsed.train.get(x_axis, [])
    x_te = parsed.test.get(x_axis, [])
    lr_ax = None
    plotted = []
    for name in fields:
        if name in ("loss",) and parsed.train.get("loss"):
            ax.plot(x_tr, parsed.train["loss"], label="train loss",
                    color="tab:blue")
            plotted.append(name)
        elif name == "lr" and parsed.train.get("lr"):
            lr_ax = ax.twinx()
            lr_ax.plot(x_tr, parsed.train["lr"], label="lr",
                       color="tab:gray", linestyle="--", alpha=0.6)
            lr_ax.set_ylabel("learning rate")
            lr_ax.set_yscale("log")
            plotted.append(name)
        elif parsed.test.get(name):
            ax.plot(x_te, parsed.test[name], label=f"test {name}",
                    marker="o", linestyle="-")
            plotted.append(name)
    ax.set_xlabel("iteration" if x_axis == "iters" else "seconds")
    ax.set_ylabel("loss / metric")
    handles, labels = ax.get_legend_handles_labels()
    if lr_ax is not None:
        h2, l2 = lr_ax.get_legend_handles_labels()
        handles += h2
        labels += l2
    if handles:
        ax.legend(handles, labels, loc="best")
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(output)
    plt.close(fig)
    return output

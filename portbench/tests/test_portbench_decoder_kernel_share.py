"""priors.decoder_kernel_share's reader on hand-made runs: None where the
program counts no `depth_conv3_macs` (a parent without the decoder's
kernel, an untraced run, a CPU run), 100% where the counter equals the
decoder's multiply-adds of the slice's frames.

    python -m pytest portbench/tests -q
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.lib import depth_work, harness  # noqa: E402

CELL = "leres_cimle_rx101.priors_448"
METRIC = "priors.decoder_kernel_share"


def _cell_and_work():
    cell = harness.Cell(ROOT, CELL)
    tr = cell.traffic
    return cell, depth_work.frame_work(cell.config, tr["crop"],
                                       tr["hypotheses"], tr["minibatch"])


def test_the_cell_reports_the_metric():
    cell, _ = _cell_and_work()
    assert METRIC in [m["name"] for m in cell.metrics(trace=True)]


def test_reader_reads_the_counter_over_the_decoder_work():
    cell, work = _cell_and_work()
    read = cell.reader(METRIC).read
    frames = 2
    trace = dict(frames=frames, counters={})
    assert read(dict(work=work)) is None                    # untraced
    assert read(dict(work=work, trace=trace)) is None       # no counter
    full = work["decoder_macs"] * frames
    trace["counters"] = {"depth_conv3_macs": full, "depth_frames": frames}
    assert read(dict(work=work, trace=trace)) == 100.0
    trace["counters"]["depth_conv3_macs"] = full // 2
    assert read(dict(work=work, trace=trace)) == 50.0
    # 2 frames of 10 hypotheses at 448^2: 793.6 G multiply-adds a frame
    assert round(work["decoder_macs"] / 1e9, 1) == 793.6

"""The beam-decoding driver end to end on the CPU at a tiny size."""

from test_bench_train import run_cell


def test_decode_cell_correct(bench_root):
    line = run_cell(bench_root, "tiny.decode")
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"decode_utts_per_s", "setup_s"}

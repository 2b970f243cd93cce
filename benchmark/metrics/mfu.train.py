"""The model's matrix-product FLOPs that the window's completed work
needed (``benchmark/yardstick/model_flops.py``), over the window's
time, as a percentage of the compute dtype's dense peak."""


def read(rec):
    if rec.get("kind") != "train" or not rec.get("model_flops"):
        return None
    return 100.0 * rec["model_flops"] / rec["window_s"] / rec["peak_flops"]

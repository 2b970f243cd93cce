"""Device-resident epoch feature cache (``extras.hbm_cache``): the
counterpart of ``ast_tpu/data/device_cache.py`` on a torch device.

Host feeding copies every batch's feature block to the card every epoch
(1.3-2.8 MB for 32 rows of 640-1,680 frames).  The cache copies each
bucket's padded feature matrix to the device once; a train or eval batch
is then a gather over the epoch's row indices (:func:`gather_batch`), and
only indices, the frame-dropout mask and targets cross per batch
(``data.dataloader``'s ``index_cache`` mode).

Bit-exactness: with a float32 cache, ``gather_batch`` is bit-equal to
the host-assembled block.  Rows are stored as ``_load_speech`` returns
them, zero-padded to the bucket's width (the zeros of the host batch);
the loader draws the dropout indices from the same stream; and a 0/1
float32 multiply is what host assembly does.  ``dtype`` bfloat16
(``extras.hbm_cache_dtype``) halves the device memory and rounds each
feature once on upload, so it is not bit-exact.

Under data parallelism (``ast_tpu_torch.parallel``) every rank holds
the whole cache of a split, as ``ast_tpu`` replicates it over its mesh;
a batch's ``rows_idx`` and ``drop_mask`` are sliced to the rank's rows
like any other batch array, and the gather runs on those.
"""

import numpy as np
import torch


class EpochFeatureCache:
    """Per-bucket device feature matrices of one split.

    ``bucket_array(b)`` is a ``(N_b + 1, T_b, D)`` tensor on ``device``
    whose last row is all zeros (the gather target of batch-padding rows,
    ``pad_row(b)``); ``row_of[utt]`` and ``true_len[utt]`` feed the
    loader's index-mode batches; ``nbytes`` is the device bytes held.
    """

    def __init__(self, loader, set_key, device="cpu", dtype=torch.float32):
        if getattr(loader, "text_mode", False):
            raise ValueError("hbm_cache: text-encoder mode buckets "
                             "token ids, not features")
        info = loader.buckets[set_key]
        self.set_key = set_key
        self.row_of, self.true_len = {}, {}
        self._arrays = [None] * info["num_b"]
        self._pad_rows = [0] * info["num_b"]
        # the loader's host feature cache would keep a second copy of
        # every row read here, which no batch reads again
        prev = getattr(loader, "cache_features", None)
        if prev:
            loader.cache_features = False
        try:
            self.nbytes = self._build(loader, info, torch.device(device),
                                      dtype)
        finally:
            if prev is not None:
                loader.cache_features = prev

    def _build(self, loader, info, device, dtype):
        num_b, width_b = info["num_b"], info["width_b"]
        max_sp = (num_b + 1) * width_b
        total = 0
        for b, bucket in enumerate(info["buckets"]):
            if not bucket:
                continue
            T = max_sp if b == num_b - 1 else (b + 1) * width_b
            feats = []
            for row, utt in enumerate(bucket):
                x = loader._load_speech(utt, self.set_key, max_sp)
                self.row_of[utt] = row
                self.true_len[utt] = len(x)
                feats.append(np.asarray(x, np.float32))
            arr = np.zeros((len(bucket) + 1, T, feats[0].shape[1]),
                           dtype=np.float32)
            for row, x in enumerate(feats):
                arr[row, :len(x)] = x
            t = torch.from_numpy(arr).to(dtype)
            self._pad_rows[b] = len(bucket)
            self._arrays[b] = t.to(device)
            total += t.numel() * t.element_size()
        return total

    def bucket_array(self, b):
        return self._arrays[b]

    def pad_row(self, b):
        """Index of the all-zero row that batch padding gathers."""
        return self._pad_rows[b]


def gather_batch(array, rows, mask):
    """A batch's features out of ``bucket_array``: ``array[rows]`` in
    float32 times the frame-dropout ``mask`` (B, T) on every feature
    (``ast_tpu``'s gather in its train step, a plain torch gather)."""
    return (torch.index_select(array, 0, rows).float()
            * mask.float()[:, :, None])

"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds: the
same files, with widths, pools and sample counts shrunk (the recurrent
product in f32, as the port takes it at H <= 512), and ``config``'s
settings on top."""
from __future__ import annotations

from port_bench import manifest

TEXT = dict(ni=16, enc_nh=32, dec_nh=32, nz=4, vocab_size=1030, batch_size=4,
            train_sentences=64, test_sentences=16, iw_nsamples=20, iw_batch=10,
            length_mean=10, length_std=4, length_min=3, length_max=30, burn_max_iters=20,
            burn_window=5)


def tiny_cell(name: str, config: dict | None = None) -> manifest.Cell:
    cell = manifest.load_cell(name, manifest.load_json(manifest.find_manifest()))
    c = cell.config
    c.update(TEXT, **(config or {}))
    c["precision"] = dict(c["precision"], lstm_recurrent="float32")
    cell.traffic = dict(cell.traffic, outer_per_call=min(cell.traffic.get("outer_per_call", 1), 4),
                        check_batches=2)
    return cell

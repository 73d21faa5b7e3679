"""The per-layer metrics that read the program's own spans
(``ltbench/program_spans.py``): a traced CPU run of each cell stays
correct, and each of its new metrics reads a number, but those that wait
on the card, which read None on the CPU."""

import json

import pytest

from ltbench import run

STEPS = ["read_wait", "stage", "plan", "card_wait", "small_wait",
         "asset_hash"]
NEW = {
    "lz4.build-upsync": [f"index_{k}_pct.upsync" for k in STEPS] + [
        "write_put_queue_pct", "write_put_offcpu_pct",
        "codec_upload_ms_per_mib", "codec_card_wait_ms_per_mib",
        "lz4_assemble_ms_per_mib"],
    "lz4.patch-downsync": [f"index_{k}_pct.downsync" for k in STEPS] + [
        "change_decode_ms_per_mib"],
}


@pytest.mark.parametrize("cell", sorted(NEW))
def test_traced_cpu_run_reads_program_spans(at_root, capsys, cell):
    argv = ["--workload", cell, "--seed", str((1 << 31) + 11),
            "--seconds", "0", "--trace", "1", "--device", "cpu", "--tiny"]
    assert run.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for name in NEW[cell]:
        if "card_wait" in name:
            assert name not in got, name
        else:
            assert got[name]["value"] >= 0, name
    shares = [got[n]["value"] for n in NEW[cell]
              if n.startswith("index_") and n in got]
    assert len(shares) == 5 and sum(shares) <= 100.0

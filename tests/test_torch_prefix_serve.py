"""Port parity of serve's ``--share-prefix`` / ``--prefix-retain``: the
shared-prefix workload's prompts and JSON keys against the reference's,
a CPU run at serve's defaults, and the flag checks that exit.  The
engine's sharing and retention are held to the reference's in
``tests/test_torch_prefix.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.launch import serve as r_serve  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402

SHARE_FLAGS = ["--reduced", "--paged", "--chunked-prefill", "--share-prefix",
               "--prefix-retain", "6"]


def _prompts_of(monkeypatch, module, argv):
    """Run ``module.run(argv)`` and return (its prompts, its output)."""
    seen = []
    real = module.Engine.submit

    def submit(self, prompt, *a, **kw):
        seen.append(np.asarray(prompt).tolist())
        return real(self, prompt, *a, **kw)
    monkeypatch.setattr(module.Engine, "submit", submit)
    out = module.run(module.parse_args(argv))
    monkeypatch.setattr(module.Engine, "submit", real)
    return seen, out


def test_serve_share_prefix_prompts_and_keys_match_repro(monkeypatch):
    """The shared-prefix workload is the reference's token for token, and
    the JSON's ``prefix_sharing`` has the reference's keys."""
    argv = SHARE_FLAGS + ["--quantize", "none", "--requests", "4",
                          "--max-new", "3"]
    r_prompts, r_out = _prompts_of(monkeypatch, r_serve, argv)
    t_prompts, t_out = _prompts_of(monkeypatch, t_serve,
                                   argv + ["--device", "cpu"])
    assert t_prompts == r_prompts
    assert all(p[:16] == r_prompts[0][:16] for p in r_prompts)
    assert set(t_out["prefix_sharing"]) == set(r_out["prefix_sharing"])
    assert t_out["all_done"] and t_out["prefix_sharing"]["hits"] > 0


def test_serve_share_prefix_runs_on_the_cpu(tmp_path):
    """The shared-prefix serve at its defaults (data-free quantization)."""
    out = t_serve.run(t_serve.parse_args(
        ["--device", "cpu"] + SHARE_FLAGS
        + ["--json-out", str(tmp_path / "o.json")]))
    st = out["prefix_sharing"]
    assert out["all_done"] and out["generated_tokens"] == 8 * 16
    assert st["hits"] > 0 and st["cow_copies"] == 0
    assert out["engine_metrics"]["prefill_tokens_skipped"] > 0
    assert (tmp_path / "o.json").exists()


@pytest.mark.parametrize("argv", [["--share-prefix"],
                                  ["--paged", "--prefix-retain", "4"]])
def test_serve_prefix_flags_exit_as_repro(argv):
    argv = ["--reduced", "--quantize", "none"] + argv
    with pytest.raises(SystemExit) as r:
        r_serve.run(r_serve.parse_args(argv))
    with pytest.raises(SystemExit) as t:
        t_serve.run(t_serve.parse_args(argv + ["--device", "cpu"]))
    assert str(t.value) == str(r.value) and "requires" in str(t.value)

"""The plain references against the program's eager path on the CPU, at
tiny sizes in float32: the prefill's last logits and every decode step's
logits through the cache against one reference pass over the prompt and
the tokens fed.  The tests import the program; the references do not."""

import copy
import subprocess
import sys

import pytest
import torch

from bench import reference
from bench.reference import common, llama, mamba2
from bench.spec import ROOT
from bench.tests import tiny
from bench.weights import SeededWeights
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api


def _float32(conf: dict) -> dict:
    conf = copy.deepcopy(conf)
    conf["port"]["dtype"] = "float32"
    return conf


@pytest.mark.parametrize("conf,T", [(tiny.MAMBA, 32), (tiny.MAMBA, 24),
                                    (tiny.LLAMA, 32), (tiny.LLAMA, 17)])
def test_reference_matches_the_programs_prefill_and_decode(conf, T):
    conf = _float32(conf)
    cfg = ModelConfig(**conf["port"])
    w = SeededWeights(api.param_specs(cfg), torch.float32, "cpu", seed=3)
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (3, T), generator=gen)
    steps = 4
    logits, cache = api.prefill(w.params, {"tokens": tokens.int()}, cfg,
                                capacity=T + steps)
    got = [logits]
    tok = logits.argmax(-1).int()
    fed = [tok]
    pos = torch.tensor(T, dtype=torch.int32)
    for _ in range(steps):
        logits, cache = api.decode_step(w.params, cache, tok, pos, cfg)
        got.append(logits)
        tok = logits.argmax(-1).int()
        fed.append(tok)
        pos = pos + 1
    seq = torch.cat([tokens, torch.stack(fed[:-1], 1).long()], 1)
    want = reference.module(conf).forward(conf, w.params, seq,
                                          torch.arange(T - 1, T + steps))
    got = torch.stack(got, 1)
    assert want.shape == got.shape
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("conf", [tiny.MAMBA, tiny.LLAMA])
def test_fp8_control_departs_from_float32(conf):
    conf = _float32(conf)
    cfg = ModelConfig(**conf["port"])
    w = SeededWeights(api.param_specs(cfg), torch.float32, "cpu", seed=5)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(6))
    pos = torch.arange(16)
    ref = reference.module(conf)
    f32 = ref.forward(conf, w.params, tokens, pos)
    f8 = ref.forward(conf, w.params, tokens, pos, prec="fp8")
    err = (f8 - f32).abs().max().item()
    assert 1e-3 < err < 0.5 * f32.abs().max().item()


def test_fp8_control_rounds_attention_and_the_scan_too():
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(1, 8, 2, 16, generator=gen) for _ in range(3))
    assert not torch.equal(llama.attention(q, k, v, "fp8"),
                           llama.attention(q, k, v))
    X = torch.randn(1, 8, 2, 4, generator=gen)
    A = -torch.rand(1, 8, 2, generator=gen)
    B, C = (torch.randn(1, 8, 3, generator=gen) for _ in range(2))
    f32, f8 = mamba2.ssd(X, A, B, C, 4), mamba2.ssd(X, A, B, C, 4, "fp8")
    err = (f8 - f32).abs().max().item()
    assert 1e-3 < err < 0.25 * f32.abs().max().item()


def test_fp8_rounding_keeps_the_scale():
    x = torch.tensor([[1.0, -448.0, 3.0], [0.5, 0.25, -0.125]])
    r = common.fp8_round(x, -1)
    assert r[0, 1].item() == -448.0 and r[1, 0].item() == 0.5
    torch.testing.assert_close(r, x, atol=0.07 * 448, rtol=0.07)


def test_references_import_nothing_of_the_program():
    code = ("import sys; import bench.reference.mamba2, bench.reference."
            "llama, bench.reference.common; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro', 'repro_torch', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"

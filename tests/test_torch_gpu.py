"""Card-only tests of the PyTorch port: the CUDA rmsnorm kernel against
its plain version, and the engine on the card. Each test skips without a
CUDA device. This file imports no JAX, so on a machine with a card and
without JAX it runs on its own:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Tolerances: f32 within 1e-5 (the kernel sums a row in another order than
PyTorch's mean); bf16 within 1 bf16 ulp (the same f32 result rounded
after sums that differ in their last bits).
"""

import pytest
import torch

from ray_tpu_torch.models import configs, init_params
from ray_tpu_torch.models.generate import generate
from ray_tpu_torch.ops import rmsnorm
from ray_tpu_torch.ops.rmsnorm import _rmsnorm_plain, rmsnorm_cuda
from ray_tpu_torch.serve.llm import ContinuousBatchingEngine

torch.set_num_threads(1)

EPS = 1e-6

pytestmark = pytest.mark.gpu


@pytest.fixture
def engines():
    made = []
    yield made
    for e in made:
        e.shutdown()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bf16_ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    def ordered(t):
        i = t.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def _assert_close(got, want):
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _bf16_ulp_diff(got, want) <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [128, 4096, 100])
@pytest.mark.parametrize("rows", [1, 5, 8, 64, 2048])
def test_rmsnorm_cuda_kernel_matches_plain(cuda_device, rows, d, dtype):
    """d=100 leaves a scalar tail after the 16-byte loads."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(rows + d)
    x = (torch.randn((rows, d), generator=gen, device=cuda_device) * 3).to(tdt)
    w = (torch.randn(d, generator=gen, device=cuda_device) * 0.1 + 1).to(tdt)
    before = rmsnorm_cuda.launches
    got = rmsnorm(x, w, EPS)
    torch.cuda.synchronize()
    assert rmsnorm_cuda.launches == before + 1
    _assert_close(got, _rmsnorm_plain(x, w, EPS))
    # A strided row view (every other row) and a misaligned one.
    _assert_close(rmsnorm(x[::2], w, EPS), _rmsnorm_plain(x[::2], w, EPS))
    xs = x[:, 1:]
    _assert_close(rmsnorm(xs, w[1:].contiguous(), EPS),
                  _rmsnorm_plain(xs, w[1:], EPS))


def test_rmsnorm_cuda_refuses_grad_and_bad_input(cuda_device):
    x = torch.randn(4, 128, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError):
        rmsnorm(x, torch.ones(128, device=cuda_device))
    with pytest.raises(TypeError):
        rmsnorm(torch.ones(4, 128, device=cuda_device, dtype=torch.float16),
                torch.ones(128, device=cuda_device, dtype=torch.float16))
    with pytest.raises(ValueError):
        rmsnorm(torch.ones(4, 128, device=cuda_device).T,
                torch.ones(4, device=cuda_device))


@pytest.mark.parametrize("name", ["tiny", "tiny_qwen"])
def test_engine_on_card_equals_generate(cuda_device, engines, name):
    cfg = configs.NAMED_CONFIGS[name]
    params = init_params(cfg, seed=0, device=cuda_device)
    prompts = [[1, 2, 3], [5, 6, 7, 8, 9], list(range(10, 29))]
    refs = [generate(params, [p], cfg, max_new_tokens=6)[0].tolist()
            for p in prompts]
    for mode in ("paged", "slotted"):
        eng = ContinuousBatchingEngine(params, cfg, num_slots=2, max_len=64,
                                       prefill_chunk=8, kv_mode=mode,
                                       page_size=4)
        engines.append(eng)
        outs = [eng.submit(p, 6).result(120) for p in prompts]
        assert outs == refs, mode

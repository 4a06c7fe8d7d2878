"""The port's LM decode-serving loop on the CPU, against the JAX package.

``repro_torch.launch.serve.generate`` steps the prompt through the KV cache
and decodes greedily, as the reference's eager loop does with its jitted
``make_decode_step``.  Its tokens must equal the reference's at every step
where the reference's top-2 logit margin exceeds twice the logit tolerance
of ``tests/test_torch_lm.py`` (5e-3 in float32 compute, 1e-2 in bf16):
there no rounding difference can change the choice.  Once a low-margin
step chose differently, the sequences no longer see the same inputs and
the rest of that row is excluded; the test reports how many steps it
excluded (``record_property``) and fails if more than a quarter were.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch.steps import make_decode_step as j_make_decode_step  # noqa: E402
from repro.launch.steps import quantize_tree_for_serving as j_quantize_tree  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.common import get_config as j_get_config  # noqa: E402
from repro.models.testing import reduce_config as j_reduce  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.common import get_config  # noqa: E402
from repro_torch.models.testing import reduce_config  # noqa: E402

TOL = {"float32": 5e-3, "bfloat16": 1e-2}


def _jax_generate(params, cfg, prompt, tokens):
    """The reference's loop (examples/serve_decode.py legacy_main) with its
    jitted decode step, also returning every greedy decision's top-2
    margin: decision 0 is the token fed back after the prompt, decision
    i + 1 produced output i."""
    step = jax.jit(lambda p, t, c: jlm.decode_step(p, t, c, cfg))
    decide = jax.jit(j_make_decode_step(cfg))
    B, P = prompt.shape
    cache = jlm.init_cache(cfg, B, P + tokens + 1,
                           dtype=jnp.dtype(cfg.compute_dtype))
    margins, out = [], []

    def one(tok, cache):
        logits, _ = step(params, tok, cache)
        nxt, cache = decide(params, {"tokens": tok}, cache)
        top2 = np.sort(np.asarray(logits[..., :cfg.vocab], np.float32),
                       axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        return nxt[:, None], cache

    for t in range(P):
        tok, cache = one(prompt[:, t:t + 1], cache)
    margins = margins[-1:]
    for _ in range(tokens):
        tok, cache = one(tok, cache)
        out.append(np.asarray(tok)[:, 0])
    return np.stack(out, 1), np.stack(margins, 1)


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_generate_tokens_equal_jax_loop(compute_dtype, bits, record_property):
    jc = j_reduce(j_get_config("qwen2.5-3b"), compute_dtype=compute_dtype)
    tc = reduce_config(get_config("qwen2.5-3b"), compute_dtype=compute_dtype)
    jp = jlm.init_params(jax.random.PRNGKey(10 + bits), jc)
    if bits:
        jp = j_quantize_tree(jp, bits)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    B, P, T = 3, 6, 10
    prompt = np.random.default_rng(bits).integers(0, jc.vocab, (B, P)
                                                  ).astype(np.int32)
    want, margin = _jax_generate(jp, jc, jnp.asarray(prompt), T)
    got = serve.generate(tp, tc, prompt, T, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, T)
    got = got.numpy()
    thr = 2 * TOL[compute_dtype]
    excluded = 0
    for b in range(B):
        for i in range(T):
            if got[b, i] != want[b, i]:
                assert margin[b, 0] <= thr or margin[b, i + 1] <= thr, (
                    f"row {b} step {i}: {got[b, i]} != {want[b, i]} at a "
                    f"top-2 margin of {margin[b, i + 1]:.3g} > {thr}")
                excluded += T - i
                break
    record_property("excluded_steps", f"{excluded} of {B * T}")
    assert excluded <= B * T // 4, f"{excluded} of {B * T} steps excluded"


def test_main_runs_on_the_cpu(capsys):
    ids = serve.main(["--arch", "qwen2.5-3b", "--reduced", "--bits", "4",
                      "--batch", "2", "--prompt-len", "3", "--tokens", "5",
                      "--device", "cpu"])
    assert tuple(ids.shape) == (2, 5) and ids.dtype == torch.int32
    out = capsys.readouterr().out
    assert "serving at w4 (packed int4 weights)" in out
    assert "generated 5 tokens x 2 seqs on cpu" in out


def test_card_is_the_default_device():
    """Without a CUDA device the entry point raises instead of running the
    CPU versions; params on another device than asked are refused."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--tokens", "1"])
    cfg = reduce_config(get_config("qwen2.5-3b"))
    params = {"embed": torch.zeros((cfg.vocab_padded, cfg.d_model),
                                   device="meta")}
    with pytest.raises(ValueError, match="params are on"):
        serve.generate(params, cfg, np.zeros((1, 2), np.int32), 1,
                       device="cpu")

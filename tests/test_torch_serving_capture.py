"""`paddle_tpu_torch.models.serving_capture` on a tiny bucketed engine on
the CPU: the rows it keeps are the logits each token was picked from; a
forced run emits the given streams, its rows drawn from the contexts the
forced streams give; a forced capture refuses a pipelined run; closing
it restores the engine and the step function. It holds no kernel, so
nothing here is held to the JAX package."""
import pytest
import torch

from paddle_tpu_torch.models import llama_serving as S
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.models.llama_serving import Request, ServingEngine
from paddle_tpu_torch.models.llama_spmd import init_params
from paddle_tpu_torch.models.serving_capture import StepLogits, bf16_step

CFG = LlamaConfig.tiny(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2,
                       ffn=64, seq=128)
# three prompts on two slots: one packed wave and one lone prefill;
# request 0 sampled, the others greedy
PROMPTS = {0: [3, 9, 27, 17, 51, 25], 1: [5, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5],
           2: [2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4, 5, 9, 0, 4]}
NEW = 8
FORK = 3    # the forced streams change each stream's token FORK


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, seed=0, device="cpu")


def _run(params, force=None, pipelined=False):
    eng = ServingEngine(params, CFG, max_seqs=2, max_seq_len=64,
                        page_size=8, ragged=False, device="cpu")
    for rid, p in PROMPTS.items():
        eng.submit(Request(rid, p, max_new_tokens=NEW,
                           **({"temperature": 0.8, "top_k": 20, "seed": 7}
                              if rid == 0 else {})))
    cap = StepLogits(eng, force=force)
    try:
        done = eng.run_pipelined() if pipelined else eng.run()
    finally:
        cap.close()
    return {r.rid: list(r.output) for r in done}, cap, eng


@pytest.fixture(scope="module")
def free(params):
    return _run(params, pipelined=True)


@pytest.fixture(scope="module")
def forced(params, free):
    streams = {rid: t[:FORK] + [(t[FORK] + 1) % CFG.vocab_size] + t[FORK + 1:]
               for rid, t in free[0].items()}
    return streams, _run(params, force=streams)


def test_rows_are_the_logits_each_greedy_token_was_picked_from(free):
    toks, cap, _ = free
    assert cap.steps.shape[1:] == (2, CFG.vocab_size)
    for rid, t in toks.items():
        assert len(t) == NEW
        for j, tok in enumerate(t):
            row = cap.row(rid, j)
            assert row.shape == (CFG.vocab_size,) and row.dtype == \
                torch.float32
            if rid != 0:
                assert int(torch.argmax(row)) == tok, (rid, j)


def test_forced_run_emits_the_streams_from_their_contexts(free, forced):
    """Every request, the sampled one too, finishes with its forced
    stream; up to the changed token each row is the free run's (the
    same context), and the row after it is not (the forced token was
    fed)."""
    toks, one, _ = free
    streams, (got, cap, _) = forced
    assert got == streams
    for rid in streams:
        for j in range(FORK + 1):
            torch.testing.assert_close(cap.row(rid, j), one.row(rid, j),
                                       atol=1e-5, rtol=0)
        assert (cap.row(rid, FORK + 1) - one.row(rid, FORK + 1)).abs() \
            .max() > 1e-3


def test_forced_capture_refuses_a_pipelined_run(params, free):
    with pytest.raises(RuntimeError, match="synchronous"):
        _run(params, force=free[0], pipelined=True)


def test_close_restores_the_engine_and_the_step_function(free):
    _, cap, eng = free
    assert S.decode_step is cap._decode and cap.eng is None
    for name in ("_seed_first_token", "_emit", "_bucket_finish"):
        assert name not in vars(eng)


@pytest.mark.parametrize("x, step", [(4.0, 2 ** -5), (5.4375, 2 ** -5),
                                     (-0.75, 2 ** -8), (1.0, 2 ** -7)])
def test_bf16_step_is_the_spacing_of_bf16_values(x, step):
    """x is a bf16 value: x + step is the next one, and a quarter step
    above x rounds back to x."""
    assert bf16_step(x) == step
    a = abs(x)
    got = torch.tensor([a, a + step, a + step / 4]).bfloat16().float()
    assert got.tolist() == [a, a + step, a]

"""The logits each token of a bucketed serving run was drawn from, and
teacher forcing along a given stream: the one hook by which a harness or
a test holds two engines' logits to each other row by row.

    cap = StepLogits(eng)                   # before eng.run*()
    done = eng.run_pipelined()
    cap.close()
    cap.row(rid, j)                         # (V,) fp32, token j of rid

    cap = StepLogits(eng, force={rid: tokens})
    done = eng.run()                        # emits `tokens`, synchronous

Two engines that differ in rounding part where their top logits nearly
tie, and after that their contexts differ. Forced along one stream, the
other engine's every row is drawn from the same context as that
stream's, so the two engines' rows can be compared at every token.

It wraps the engine's `_seed_first_token`, `_emit` and
`_bucket_finish` and the module's `decode_step` while it is installed;
a bucketed engine without speculative decoding is what it reads."""
import math

import torch


def bf16_step(x):
    """The spacing of bf16 values at magnitude |x|."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


class StepLogits:
    """The seed rows the prefills hand `_seed_first_token`, and the (B, V)
    logits of every decode step, kept on the device (nothing is read
    while the run lasts), with the step and slot each decode row fed.

    `force` ({rid: tokens}) makes the engine emit those tokens in place
    of its own picks, the first one included, so that each next step
    feeds them. Only a synchronous `run()` feeds the emitted token; a
    pipelined step feeds the device's own pick, which a forced capture
    refuses (RuntimeError). `close` takes the capture off and moves the
    decode steps' logits to the host."""

    def __init__(self, eng, force=None):
        from paddle_tpu_torch.models import llama_serving as S
        self.eng, self.S, self.force = eng, S, force
        self.steps, self.seeds, self.rows = [], {}, {}
        self._decode = S.decode_step
        self._finished = 0
        seed, emit, finish = (eng._seed_first_token, eng._emit,
                              eng._bucket_finish)

        def decode_step(*a, **k):
            mask = k.get("carry_mask")
            if force is not None and mask is not None and bool(mask.any()):
                raise RuntimeError("a forced capture needs a synchronous "
                                   "run(): a pipelined step feeds the "
                                   "device's own token")
            out = self._decode(*a, **k)
            self.steps.append(out[0] if isinstance(out, tuple) else out)
            return out

        def seed_first(slot, req, row):
            self.seeds[req.rid] = row
            out = seed(slot, req, row)
            want = self._forced(req, 0)
            if want is not None:
                req.output[0] = req.next_token = want
                if eng.tok_buf is not None and not req.done:
                    eng.tok_buf[slot, int(eng.lengths[slot])] = want
            return out

        def bucket_finish(ticket, inflight=None):
            self._finished += 1
            return finish(ticket, inflight=inflight)

        def emit_row(s, req, tok, *a):
            j = len(req.output)
            self.rows[(req.rid, j)] = (self._finished - 1, s)
            want = self._forced(req, j)
            return emit(s, req, tok if want is None else want, *a)
        S.decode_step = decode_step
        eng._seed_first_token, eng._emit = seed_first, emit_row
        eng._bucket_finish = bucket_finish

    def _forced(self, req, j):
        if self.force is None or req.rid not in self.force:
            return None
        return int(self.force[req.rid][j])

    def close(self):
        """Take the capture off (the engine is no longer held); the
        decode steps' logits move to the host."""
        self.S.decode_step = self._decode
        del (self.eng._seed_first_token, self.eng._emit,
             self.eng._bucket_finish)
        self.eng = None
        self.steps = torch.stack(self.steps).cpu() if self.steps else None

    def row(self, rid, j):
        """The logits token j of request rid was drawn from (fp32, on the
        host; call after `close`)."""
        if j == 0:
            return torch.as_tensor(self.seeds[rid]).float()
        k, s = self.rows[(rid, j)]
        return self.steps[k][s].float()

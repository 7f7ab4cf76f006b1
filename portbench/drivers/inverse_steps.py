"""Inverse rendering: descent steps of `diff.inverse.recover_materials`
(BASELINE.json config #5) from start parameters drawn from the seed,
one step after another.

Set-up builds the scene, renders the target image with the true
parameters (key from the seed), draws the start point (each diffuse
albedo that carries a gradient, a material that is neither mirror nor
glass, uniform in `start_diffuse`; the emission scaled by a factor
uniform in `start_emission_scale`), and starts ONE recover_materials
call.  Its first `checked_steps` steps are set-up: the first warms every
shape, and all of them are compared with the reference.  The same call
then goes on into the window; its callback stamps each step and ends the
window by raising.

End to end: step_s, the window's wall over the steps completed in it.
Compared (`compare.norm_gaps`, worst leaf, over the fields):
`loss_gap` (the widest relative gap of the checked steps' losses),
`grad_gap` (the first step's gradient, as recover_materials hands it to
its update) and `update_gap` (the parameters' change after the checked
steps, as the next step reads them).  Leaves whose reference gradient
is under a thousandth of the median leaf's are left out of the change.
"""
from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np
import torch

from portbench.harness import compare, packages
from portbench.harness.common import SpanChain, WindowClosed, span


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.c = ctx.config
        self.traffic = ctx.traffic
        self.target_seed = ctx.seeds.key_seed()
        self.train_seed = ctx.seeds.key_seed()
        self.start_seed = ctx.seeds.key_seed()
        self.window_steps = 0

    # -- either implementation ------------------------------------------
    def _build(self, pkg):
        dev = self.ctx.device
        scene, _, cam = packages.scene(pkg, self.c, dev)
        bdpt = packages.module(pkg, "integrators.bdpt")
        cfg = bdpt.BDPTConfig(self.c["width"], self.c["height"],
                              spp=self.c["spp"], **self.c["bdpt"])
        return scene, cam, cfg

    def _start(self, pkg, scene):
        """The start point (the same draw for either implementation)."""
        grad = packages.module(pkg, "diff.grad")
        bsdf = packages.module(pkg, "bsdf.bsdf")
        true = grad.extract_params(scene)
        gen = np.random.default_rng(self.start_seed)
        kind = scene.mat.kind.cpu().numpy()
        free = ~((kind == bsdf.MIRROR) | (kind == bsdf.GLASS))
        lo, hi = self.traffic["start_diffuse"]
        kd = true["diffuse"].cpu().numpy().copy()
        kd[free] = gen.uniform(lo, hi, size=kd[free].shape)
        lo, hi = self.traffic["start_emission_scale"]
        scale = gen.uniform(lo, hi)
        dev = self.ctx.device
        return true, {"diffuse": torch.as_tensor(kd, dtype=torch.float32,
                                                 device=dev),
                      "emission": true["emission"] * scale}

    def _descend(self, pkg, callback, setup_done=None, iterations=None):
        """Set-up and one recover_materials call of `pkg`; the first
        `checked_steps` steps are recorded: (losses, first gradient,
        parameters after them, start point)."""
        dev = self.ctx.device
        rng = packages.module(pkg, "core.rng")
        grad = packages.module(pkg, "diff.grad")
        inverse = packages.module(pkg, "diff.inverse")
        scene, cam, cfg = self._build(pkg)
        true, start = self._start(pkg, scene)
        with torch.no_grad(), span("target"):
            target = grad.render_with_params(
                true, scene, cam.device_constants(dev), cfg,
                rng.key(self.target_seed, dev), cfg.spp)
        n = self.traffic["checked_steps"]
        rec = {"losses": [], "grads": [], "start": _host(start)}
        inner = inverse.loss_and_grad

        def recorded(*a, **k):
            loss, g = inner(*a, **k)
            if len(rec["grads"]) < n:
                rec["grads"].append(_host(g))
            return loss, g

        def cb(it, loss, params):
            if it < n:
                rec["losses"].append(float(loss))
                if it == n - 1:
                    rec["params"] = _host(params)
                    if setup_done is not None:
                        setup_done()
                return
            callback(it)

        with mock.patch.object(inverse, "loss_and_grad", recorded), \
                contextlib.suppress(WindowClosed), span("recover_materials"):
            inverse.recover_materials(
                scene, cam, cfg, target, fields=tuple(self.c["fields"]),
                init_params=start,
                iterations=iterations or self.traffic["max_steps"],
                lr=self.c["lr"], spp_chunk=cfg.spp, seed=self.train_seed,
                callback=cb)
        return rec

    # -- the program ------------------------------------------------------
    def run(self, clock):
        steps = SpanChain("descent_step")

        def setup_done():
            clock.setup_done()
            steps.next()

        def step(it):
            steps.close()
            self.window_steps += 1
            if clock.unit_done():
                raise WindowClosed
            steps.next()

        self.record = self._descend(packages.PROGRAM, step,
                                    setup_done=setup_done)
        steps.close()
        if clock.units == 0:
            raise RuntimeError("recover_materials ended before the window")

    def end_to_end(self, clock) -> dict:
        return {"step_s": clock.wall / clock.units}

    def counts(self) -> dict:
        return {"attempted": self.window_steps, "failed": 0,
                "steps": self.window_steps}

    def release(self):
        return self.record

    # -- the reference ------------------------------------------------------
    def reference_record(self, lower=False, fault=None):
        from portbench.reference.bpt import precision

        with precision.lower() if lower else contextlib.nullcontext(), \
                plant(packages.REFERENCE, fault):
            return self._descend(packages.REFERENCE, lambda it: None,
                                 iterations=self.traffic["checked_steps"])

    def compared(self, got, ref) -> dict:
        fields = self.c["fields"]
        losses = [abs(a - b) / max(abs(b), 1e-30)
                  for a, b in zip(got["losses"], ref["losses"])]
        if len(losses) < self.traffic["checked_steps"]:
            losses.append(np.inf)
        g_ref = {f: ref["grads"][0][f] for f in fields}
        norms = {f: float(np.linalg.norm(g_ref[f])) for f in fields}
        med = float(np.median(list(norms.values())))
        keep = [f for f in fields if norms[f] >= 1e-3 * med]
        d_got = {f: got["params"][f] - got["start"][f] for f in fields}
        d_ref = {f: ref["params"][f] - ref["start"][f] for f in fields}
        return {"loss_gap": max(losses),
                "grad_gap": compare.norm_gaps(
                    {f: got["grads"][0][f] for f in fields}, g_ref),
                "update_gap": compare.norm_gaps(d_got, d_ref, keep)}

    def check(self, record) -> dict:
        return self.compared(record, self.reference_record())

    def control(self, fault=None) -> dict:
        """The reference in the program's place: in bfloat16 (the
        control), or in float32 with `fault` planted (FAULTS)."""
        got = self.reference_record(lower=fault is None, fault=fault)
        return self.compared(got, self.reference_record())


FAULTS = ("state_unchanged", "half_batch")


@contextlib.contextmanager
def plant(pkg, fault):
    """Plant `fault` in package `pkg` (program or reference):
    `state_unchanged`, a step that returns the parameters it got (the
    update scaled by 0); `half_batch`, the image loss over half the
    pixels, its mean taken over them."""
    if fault is None:
        yield
        return
    inverse = packages.module(pkg, "diff.inverse")
    grad = packages.module(pkg, "diff.grad")
    if fault == "state_unchanged":
        inner = inverse.recover_materials

        def frozen(*a, **k):
            return inner(*a, **{**k, "lr": 0.0})

        with mock.patch.object(inverse, "recover_materials", frozen):
            yield
    elif fault == "half_batch":
        def half(params, scene, cam_consts, cfg, key, spp_chunk, target_fb):
            fb = grad.render_with_params(params, scene, cam_consts, cfg, key,
                                         spp_chunk)
            n = fb.shape[0] // 2
            return torch.mean((fb[:n] * (cfg.spp / spp_chunk)
                               - target_fb[:n]) ** 2)

        with mock.patch.object(grad, "image_loss", half):
            yield
    else:
        raise ValueError(f"unknown fault {fault!r}; have {FAULTS}")


def _host(tensors: dict) -> dict:
    return {k: v.detach().double().cpu().numpy() for k, v in tensors.items()}

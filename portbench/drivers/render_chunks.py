"""A progressive render job: `chunk_spp` samples a call, `sample_offset`
advancing, the framebuffer accumulated on the host as the port's CLI
does (bpt_tpu_torch/cli.py), one call after another (a closed loop).

The entry is integrators.bdpt.render_chunk with the configuration's
`bdpt` settings and `samples_per_batch`.  Traffic keys: `chunk_spp`,
`job_spp` (the job's total, which scales the framebuffer),
`check_chunks` (window chunks compared with the reference, drawn from
the seed), `trace_units` (chunks traced).

End to end: rays_per_s, every ray the window's calls return in `nrays`
over the window's wall.  Compared: `fb_gap` (the chunk's framebuffer
against the reference's, compare.fb_gap) and `nrays_gap` (|nrays -
the reference's|), the widest over the chunks checked.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.harness import compare, packages
from portbench.harness.common import span


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg_file = ctx.config
        self.traffic = ctx.traffic
        self.chunk_spp = self.traffic["chunk_spp"]
        self.key_seed = ctx.seeds.key_seed()
        self.pick = ctx.seeds.generator()
        self.records = []          # (sample_offset, framebuffer, nrays)
        self.total_rays = 0
        self.prog = None

    # -- either implementation ------------------------------------------
    def _render_cfg(self, pkg):
        c = self.cfg_file
        mod = packages.module(pkg, "integrators.bdpt")
        return mod.BDPTConfig(c["width"], c["height"],
                              spp=self.traffic["job_spp"], **c["bdpt"])

    def _build(self, pkg):
        scene, _, cam = packages.scene(pkg, self.cfg_file, self.ctx.device)
        rng = packages.module(pkg, "core.rng")
        return {"scene": scene, "cam": cam,
                "cc": cam.device_constants(self.ctx.device),
                "cfg": self._render_cfg(pkg),
                "key": rng.key(self.key_seed, self.ctx.device),
                "entry": packages.module(pkg, "integrators.bdpt").render_chunk,
                "sb": self.cfg_file["samples_per_batch"]}

    @staticmethod
    def _chunk(b, offset, spp):
        return b["entry"](b["scene"], b["cc"], b["cfg"], b["key"], spp,
                          sample_offset=offset, samples_per_batch=b["sb"])

    # -- the program ------------------------------------------------------
    def run(self, clock):
        """Set-up (scene, one warm chunk at offset 0), then chunks under
        `clock` until it closes the window."""
        self.prog = self._build(packages.PROGRAM)
        self.fb = np.zeros((self.cfg_file["width"] * self.cfg_file["height"],
                            3), np.float32)
        with span("warm"):
            fb_c, nr = self._chunk(self.prog, 0, self.chunk_spp)
            self.fb = self.fb + fb_c.cpu().numpy()
            int(nr)
        offset = self.chunk_spp
        clock.setup_done()
        while True:
            with span("render_chunk"):
                fb_c, nr = self._chunk(self.prog, offset, self.chunk_spp)
                fb_np = fb_c.cpu().numpy()
                self.fb = self.fb + fb_np
                n = int(nr)
            self.records.append((offset, fb_np, n))
            self.total_rays += n
            offset += self.chunk_spp
            if clock.unit_done():
                break

    def end_to_end(self, clock) -> dict:
        return {"rays_per_s": self.total_rays / clock.wall}

    def counts(self) -> dict:
        return {"attempted": len(self.records), "failed": 0,
                "samples": len(self.records) * self.chunk_spp,
                "nrays": self.total_rays}

    def probe(self, kind):
        """The roofline probe of `kind` ("closest" / "any") on the
        program's scene, bounded on the reference's table; None off the
        card."""
        from portbench.harness import roofline

        dev = self.ctx.device
        if torch.device(dev).type != "cuda":
            return None
        p = self.cfg_file["probe"]
        ref_scene, _, cam = packages.scene(packages.REFERENCE, self.cfg_file,
                                           dev)
        gen = torch.Generator(device=dev).manual_seed(self.key_seed)
        if kind == "closest":
            args = roofline.camera_rays(ref_scene, cam, p["closest_lanes"],
                                        gen, dev)
        else:
            args = roofline.segments(ref_scene, p["any_segments"],
                                     p["any_live"], gen, dev)
        return roofline.share(kind, self.prog["scene"], ref_scene, args)

    def release(self):
        """Free the program's state; return what the check reads."""
        self.prog = None
        n = self.traffic["check_chunks"]
        idx = sorted(self.pick.choice(len(self.records),
                                      min(n, len(self.records)),
                                      replace=False).tolist())
        return [self.records[i] for i in idx]

    # -- the reference ------------------------------------------------------
    def reference_records(self, offsets, lower=False):
        """The reference's chunks at `offsets` (its hits in bfloat16 with
        `lower`: the control)."""
        import contextlib

        from portbench.reference.bpt import precision

        b = self._build(packages.REFERENCE)
        out = []
        with precision.lower() if lower else contextlib.nullcontext():
            for off in offsets:
                fb_c, nr = self._chunk(b, off, self.chunk_spp)
                out.append((off, fb_c.cpu().numpy(), int(nr)))
        return out

    def compared(self, records, reference) -> dict:
        fb = max(compare.fb_gap(r[1], q[1]) for r, q in zip(records,
                                                             reference))
        nr = max(abs(r[2] - q[2]) for r, q in zip(records, reference))
        return {"fb_gap": fb, "nrays_gap": float(nr)}

    def check(self, records) -> dict:
        ref = self.reference_records([r[0] for r in records])
        return self.compared(records, ref)

    def control(self, fault=None) -> dict:
        """The control: the reference in bfloat16 in the program's place,
        on the chunks a run checks (window chunks 1..check_chunks)."""
        if fault is not None:
            raise ValueError(f"no fault {fault!r} for a render job")
        offs = [self.chunk_spp * (1 + i)
                for i in range(self.traffic["check_chunks"])]
        return self.compared(self.reference_records(offs, lower=True),
                             self.reference_records(offs))

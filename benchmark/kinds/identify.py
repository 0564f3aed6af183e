"""Kind `identify`: a closed loop of identifications of recordings made from
the seed, each unit `Data.init_from_data` then
`Identification.estimateParameters()` on one `Identification`.

Configuration keys: urdf, and structural_cache (a structural regressor file
for these options, copied beside the URDF) where there is one. Traffic
parameters: recording (a generator of benchmark.inputs.recordings) with its
sizes and noise, recordings (how many distinct recordings the units cycle
through), options (the toolkit's options, over its defaults), limits (of the
numbers judge() compares).
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import time
from collections import Counter

import numpy as np
import torch

from ..harness import roofline
from ..harness.trace import span
from ..inputs import recordings
from ..reference import identify_check, rigid_body

E2E = {"identify_s": "per_unit_s", "identify_p90_s": "p90_s"}


class Cell:
    def __init__(self, root, config, traffic, seed, device, workdir):
        self.root, self.config, self.traffic = root, config, traffic
        self.seed, self.device, self.workdir = seed, torch.device(device), workdir
        self.options = dict(traffic["options"])
        self.robot = rigid_body.load_urdf(os.path.join(root, config["urdf"]))

    # -- set-up ---------------------------------------------------------
    def setup(self):
        """Yields (part, seconds) as each part of the set-up ends."""
        t = time.perf_counter()

        def lap(name):
            nonlocal t
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            now = time.perf_counter()
            part = (name, now - t)
            t = now
            return part

        from flobaroid_tpu_torch.identification.identifier import Identification
        from flobaroid_tpu_torch.utils.config import load_config
        yield lap("import_program")

        if self.device.type == "cuda":
            from flobaroid_tpu_torch.ops import _build
            _build.load_library("gram")
            yield lap("kernel_library")

        urdf = os.path.join(self.workdir, os.path.basename(self.config["urdf"]))
        shutil.copy(os.path.join(self.root, self.config["urdf"]), urdf)
        cache = self.config.get("structural_cache")
        if cache:
            shutil.copy(os.path.join(self.root, cache), urdf + ".regressor.npz")
        opt = load_config(None, overrides=dict(self.options))
        self.idf = Identification(opt, urdf, device=self.device)
        yield lap("model")

        self.recordings = [recordings.make(self.robot, self.traffic, self.seed, k, self.device)
                           for k in range(int(self.traffic["recordings"]))]
        yield lap("inputs")

        for k in range(len(self.recordings)):
            self.unit(k)
        yield lap("warm_units")

    # -- the timed unit -------------------------------------------------
    def unit(self, u: int) -> dict:
        v = u % len(self.recordings)
        idf = self.idf
        with span("init_from_data"):
            idf.data.init_from_data(dict(self.recordings[v]))
        with span("estimateParameters"):
            idf.estimateParameters()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        m = idf.model
        return dict(v=v, x=np.array(m.xStd, dtype=float), res=float(idf.res_error),
                    G=np.array(m.G_std, dtype=float), g=np.array(m.g_tau - m.g_cf, dtype=float),
                    newton=(idf.sdp.last_info or {}).get("newton_iters") if idf.sdp else None)

    def spans(self) -> list:
        """(owner, attribute, span name) of the program's layer calls that a
        traced run wraps in spans."""
        from flobaroid_tpu_torch import model as model_mod
        from flobaroid_tpu_torch.identification import identifier, sdp

        return [
            (model_mod.Model, "computeRegressors", "regressor_gram"),
            (model_mod.Model, "_contact_jt_w", "contacts"),
            (model_mod, "gram_batched", "gram_batched"),
            (identifier.Identification, "identifyBaseParameters", "ols_wls"),
            (sdp.SDP, "initSDP_LMIs", "sdp"),
            (sdp.SDP, "identifyFeasibleStandardParameters", "sdp"),
            (identifier.Identification, "estimateRegressorTorques", "reporting"),
            (model_mod.Model, "residual_stats", "reporting"),
            (model_mod.Model, "prefetch_contractions", "reporting"),
        ]

    # -- what the per-layer readers read -------------------------------
    def gram_bound_s(self) -> float:
        """Least time of one unit's Gram work: the per-channel augmented
        Grams (P identified columns, tau and the contact column) over the
        samples, in chunks of gramChunk."""
        o = self.options
        fb = 6 if o.get("floatingBase", 0) else 0
        n = self.robot.num_dofs
        P = 10 * self.robot.num_links + (3 * n if o.get("identifyFrictionSimultaneously", 0) else 0)
        N = int(self.traffic["samples"]) // (int(o.get("skipSamples", 0)) + 1)
        return sum(roofline.gram_bound_s(c, n + fb, P + 2)
                   for c in roofline.chunks(N, int(o.get("gramChunk", 4096))))

    def layer_record(self, window) -> dict:
        done = [o for o in window.outputs if o is not None]
        return dict(units=len(done), gram_bound_s_per_unit=self.gram_bound_s())

    # -- correctness ----------------------------------------------------
    def release(self, window):
        """Keep what judge() reads, free the program's state."""
        m = self.idf.model
        last = window.outputs[-1]
        self._base_rows = None
        if self.options.get("floatingBase", 0) and last is not None:
            self._base_rows = (last["v"], m.G_rows[:6].double().cpu().numpy(),
                               (m.g_rows[:6] - m.gcf_rows[:6]).double().cpu().numpy())
        self.idf = m = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, window) -> dict:
        units = [o for o in window.outputs if o is not None]
        iters = Counter(o["newton"] for o in units)
        print(f"sdp newton iterations: units {dict(sorted(iters.items(), key=str))}",
              file=sys.stderr, flush=True)
        refs = identify_check.reference_side(self.robot, self.recordings, self.options, self.device)
        return identify_check.judge(units, refs, self.robot.num_links, self._base_rows)

"""Console and HTML reporting of identification results.

Counterpart of flobaroid_tpu/output.py (reference
identification/output.py): OutputConsole (std/base parameter tables with
a-priori vs identified vs real columns, %err / sigma% / constraint tags,
consistency summary, torque error statistics, LaTeX export;
output.py:35-679) and OutputMatplotlib (per-joint torque plots to a
self-contained HTML report, TikZ, PDF; output.py:682-960).

Host numpy: every array the report reads from the identification or its
model goes through `_host` once, so a tensor (on any device) is turned
into numpy at this boundary and never formatted as a tensor.
matplotlib and plotly are imported where a figure is drawn.
"""

from __future__ import annotations

import io

import numpy as np

from .utils import helpers

try:
    from colorama import Fore, Style

    _HAS_COLOR = True
except ImportError:  # pragma: no cover
    _HAS_COLOR = False

    class Fore:  # type: ignore
        RED = GREEN = YELLOW = CYAN = RESET = ""

    class Style:  # type: ignore
        BRIGHT = RESET_ALL = ""


def _host(a):
    """numpy array of `a` (a tensor on any device, an array, a list);
    None stays None."""
    if a is None:
        return None
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class OutputConsole:
    def __init__(self, idf):
        self.idf = idf

    def render(self, summary_only: bool = False) -> str:
        idf = self.idf
        m = idf.model
        opt = idf.opt
        lines: list[str] = []

        xStd = _host(idf._full_xstd() if len(m.xStd) else m.xStdModel)
        xReal = _host(idf.xStdReal)
        xModel = _host(m.xStdModel)
        xBase, xBaseModel = _host(m.xBase), _host(m.xBaseModel)
        xBaseReal = _host(getattr(idf, "xBaseReal", None))
        p_sigma_x = _host(idf.p_sigma_x)
        xStd_link, xModel_link = xStd, xModel
        bary = bool(opt.get("outputBarycentric", 0))
        if bary:
            # display in barycentric form [m, COM, I@COM] (reference
            # output.py:51-127)
            _l2b = helpers.params_link_to_bary
            nmp = m.num_model_params
            xStd = _l2b(xStd, nmp)
            xModel = _l2b(xModel, nmp)
            if xReal is not None:
                xReal = _l2b(xReal, nmp)

        if opt.get("showStandardParams", 1) and not summary_only:
            lines.append(
                "Standard parameters (barycentric [m, COM, I@COM]):"
                if bary
                else "Standard parameters:"
            )
            hdr = f"{'#':>4} {'name':<10} {'a priori':>12} {'identified':>12}"
            if xReal is not None:
                hdr += f" {'real':>12} {'%err':>8}"
            hdr += f" {'%chg':>8}  constraints"
            lines.append(hdr)
            tags = getattr(idf.sdp, "constr_per_param", {}) if idf.sdp else {}
            non_id = set(m.non_id)
            for ci, p in enumerate(m.identified_params):
                ap = xModel[p]
                idv = xStd[p]
                chg = 100.0 * (idv - ap) / abs(ap) if abs(ap) > 1e-12 else float("inf") if abs(idv) > 1e-9 else 0.0
                row = f"{p:>4} {m.param_names[p]:<10} {ap:>12.5g} {idv:>12.5g}"
                if xReal is not None:
                    rv = xReal[p]
                    err = 100.0 * (idv - rv) / abs(rv) if abs(rv) > 1e-12 else 0.0
                    row += f" {rv:>12.5g} {err:>8.2f}"
                row += f" {chg:>8.2f}"
                t = list(tags.get(p, []))
                if p in non_id:
                    t.append("nID")
                if t:
                    row += "  " + ",".join(t)
                lines.append(row)

        if opt.get("showBaseParams", 1) and len(xBase) and not summary_only:
            lines.append("")
            lines.append("Base parameters:")
            hdr = f"{'#':>4} {'a priori':>12} {'identified':>12}"
            if xBaseReal is not None:
                hdr += f" {'real':>12}"
            if p_sigma_x is not None:
                hdr += f" {'sigma%':>9}"
            lines.append(hdr)
            eqs = m.base_equations_str() if opt.get("showBaseEqns", 0) else None
            for i in range(m.num_base_params):
                if i >= len(xBase):
                    break
                row = f"{i:>4} {xBaseModel[i]:>12.5g} {xBase[i]:>12.5g}"
                if xBaseReal is not None:
                    row += f" {xBaseReal[i]:>12.5g}"
                if p_sigma_x is not None and i < len(p_sigma_x):
                    row += f" {100 * p_sigma_x[i]:>9.2f}"
                if eqs:
                    row += f"   {eqs[i][:70]}"
                lines.append(row)

        # consistency summary (reference output.py:599-679) — always on
        # the link-frame params, regardless of the display convention
        lines.append("")
        triangle = bool(opt.get("showTriangleConsistency", 0))
        cons = helpers.consistency_per_link(
            xStd_link[: m.num_model_params], m.num_links, triangle=triangle
        )
        bad = [m.linkNames[i] for i, ok in cons.items() if not ok]
        if bad:
            lines.append(f"physically INCONSISTENT links: {', '.join(bad)}")
        else:
            lines.append(
                "all links physically consistent "
                + ("(pseudo-inertia PSD)" if triangle else "(spatial-inertia PSD)")
            )
        total_mass = float(np.sum(xStd[0 : m.num_model_params : 10]))
        total_mass_ap = float(np.sum(xModel_link[0 : m.num_model_params : 10]))
        lines.append(f"total mass: {total_mass:.4f} kg (a priori {total_mass_ap:.4f} kg)")
        # structural identifiability triple (the reference documents the
        # analogous analysis in documentation/design_notes.md:98-103)
        try:
            tr = m.structural_identifiability()
            lines.append(
                "structural identifiability: "
                f"{tr['individually_identifiable']} individually identifiable, "
                f"{tr['base_directions']} base directions, "
                f"{tr['null_directions']} null directions "
                f"of {tr['n_inertial_params']} inertial params"
            )
        except ValueError:
            pass

        tauE = _host(idf.tauEstimated)
        if tauE is not None:
            tauM = _host(m.tauMeasured)
            rel = helpers.relative_error_pct(tauM, tauE)
            absr = float(np.mean(np.linalg.norm(tauM - tauE, axis=1)))
            limits = np.array([m.limits[j]["torque"] for j in m.jointNames])
            if opt["floatingBase"]:
                limits = np.concatenate([np.full(6, np.nan), limits])
            nrms = helpers.nrms_error_pct(tauM, tauE, limits)
            lines.append(
                f"torque estimation error: {rel:.3f}% relative, "
                f"{absr:.4f} Nm mean residual, {nrms:.3f}% NRMS"
            )
            tauAP = _host(idf.tauAPriori)
            if tauAP is not None:
                rel_ap = helpers.relative_error_pct(tauM, tauAP)
                lines.append(f"a priori torque error: {rel_ap:.3f}% relative")
                if rel < rel_ap:
                    lines.append("identified model IMPROVES on the a priori model")
                else:
                    lines.append("identified model does NOT improve on the a priori model")
        if hasattr(idf, "val_error"):
            lines.append(
                f"validation: {float(idf.val_error):.3f}% relative, "
                f"{float(idf.val_residual):.4f} Nm, {float(idf.val_nrms):.3f}% NRMS"
            )

        text = "\n".join(lines)
        print(text)
        return text

    def render_latex(self) -> str:
        """LaTeX standard-parameter table (reference output.py outputLatex)."""
        idf = self.idf
        m = idf.model
        xStd = _host(idf._full_xstd() if len(m.xStd) else m.xStdModel)
        xModel = _host(m.xStdModel)
        rows = ["\\begin{tabular}{llrr}", "\\toprule",
                "\\# & name & a priori & identified \\\\", "\\midrule"]
        for ci, p in enumerate(m.identified_params):
            name = m.param_names[p].replace("_", "\\_")
            rows.append(f"{p} & {name} & {xModel[p]:.5g} & {xStd[p]:.5g} \\\\")
        rows += ["\\bottomrule", "\\end{tabular}"]
        return "\n".join(rows)


class OutputMatplotlib:
    """Self-contained HTML report with per-joint torque plots
    (reference output.py:682-960; matplotlib SVG instead of plotly)."""

    def __init__(self, idf, text: str | None = None):
        self.idf = idf
        self.text = text

    def _figures(self):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        idf = self.idf
        m = idf.model
        opt = idf.opt
        fb = m.fb
        T = _host(m.T)
        tauM = _host(m.tauMeasured)
        tauE = _host(idf.tauEstimated)
        tauAP = _host(idf.tauAPriori)
        figs = []

        if opt.get("plotBaseDynamics", 1) and fb:
            fig, axes = plt.subplots(2, 3, figsize=(12, 5), constrained_layout=True)
            labels = ["F_x", "F_y", "F_z", "M_x", "M_y", "M_z"]
            for k in range(6):
                ax = axes[k // 3][k % 3]
                ax.plot(T, tauM[:, k], label="measured", lw=0.8)
                if tauE is not None:
                    ax.plot(T, tauE[:, k], label="estimated", lw=0.8)
                ax.set_title(labels[k])
                ax.grid(alpha=0.3)
            axes[0][0].legend(fontsize=7)
            fig.suptitle("base wrench")
            figs.append(("Base dynamics", fig))

        n_show = m.num_dofs
        if opt.get("plotPerJoint", 1):
            # one subplot per joint (reference output.py:841)
            ncols = 3
            nrows = int(np.ceil(n_show / ncols))
            fig, axes = plt.subplots(nrows, ncols, figsize=(12, 2.6 * nrows),
                                     constrained_layout=True, squeeze=False)
            for j in range(n_show):
                ax = axes[j // ncols][j % ncols]
                ax.plot(T, tauM[:, fb + j], label="measured", lw=0.8)
                if tauE is not None:
                    ax.plot(T, tauE[:, fb + j], label="estimated", lw=0.8)
                if opt.get("plotPrioriTorques", 1) and tauAP is not None:
                    ax.plot(T, tauAP[:, fb + j], label="a priori", lw=0.6, alpha=0.7)
                if opt.get("plotErrors", 0) and tauE is not None:
                    ax.plot(T, tauM[:, fb + j] - tauE[:, fb + j], label="error", lw=0.5)
                ax.set_title(m.jointNames[j], fontsize=8)
                ax.grid(alpha=0.3)
            axes[0][0].legend(fontsize=7)
        else:
            # all joints overlaid in one axes (reference plotPerJoint=0)
            fig, ax = plt.subplots(figsize=(12, 5), constrained_layout=True)
            for j in range(n_show):
                ax.plot(T, tauM[:, fb + j], lw=0.7, label=m.jointNames[j])
            if tauE is not None:
                for j in range(n_show):
                    ax.plot(T, tauE[:, fb + j], lw=0.7, ls="--")
            ax.grid(alpha=0.3)
            ax.legend(fontsize=6, ncol=4)
        fig.suptitle("joint torques")
        figs.append(("Joint torques", fig))

        # validation torques on the held-out file (reference
        # identifier.py:1170-1422 adds a validation figure set when
        # --validation was given)
        if getattr(idf, "tauEstimatedValidation", None) is not None:
            Tv = _host(idf.Tv)
            tauMv = _host(idf.tauMeasuredValidation)
            tauEv = _host(idf.tauEstimatedValidation)
            ncols = 3
            nrows = int(np.ceil(n_show / ncols))
            fig, axes = plt.subplots(nrows, ncols, figsize=(12, 2.6 * nrows),
                                     constrained_layout=True, squeeze=False)
            for j in range(n_show):
                ax = axes[j // ncols][j % ncols]
                ax.plot(Tv, tauMv[:, fb + j], label="measured", lw=0.8)
                ax.plot(Tv, tauEv[:, fb + j], label="predicted", lw=0.8)
                ax.set_title(m.jointNames[j], fontsize=8)
                ax.grid(alpha=0.3)
            axes[0][0].legend(fontsize=7)
            fig.suptitle(
                f"validation torques (held-out): {float(idf.val_error):.3f}% rel, "
                f"{float(idf.val_nrms):.3f}% NRMS"
            )
            figs.append(("Validation torques", fig))

        # measured states
        idx = np.arange(idf.data.num_used_samples) * (int(opt["skipSamples"]) + 1)
        for key, title in (("positions", "joint positions"), ("velocities", "joint velocities")):
            arr = _host(idf.data.samples[key])[idx, : m.num_dofs]
            fig, ax = plt.subplots(figsize=(12, 3), constrained_layout=True)
            for j in range(m.num_dofs):
                ax.plot(T, arr[:, j], lw=0.7, label=m.jointNames[j])
            ax.set_title(title)
            ax.grid(alpha=0.3)
            ax.legend(fontsize=6, ncol=4)
            figs.append((title, fig))
        return figs

    def _datasets(self):
        """(title, times, {label: (N,) series}) tuples — the backend-
        independent plot data (reference identifier.plot dataset
        assembly, identifier.py:1170-1422)."""
        idf = self.idf
        m = idf.model
        fb = m.fb
        T, tauM = _host(m.T), _host(m.tauMeasured)
        tauE, tauAP = _host(idf.tauEstimated), _host(idf.tauAPriori)
        out = []
        for j in range(m.num_dofs):
            series = {"measured": tauM[:, fb + j]}
            if tauE is not None:
                series["estimated"] = tauE[:, fb + j]
            if tauAP is not None:
                series["a priori"] = tauAP[:, fb + j]
            out.append((f"torque {m.jointNames[j]}", T, series))
        if getattr(idf, "tauEstimatedValidation", None) is not None:
            Tv = _host(idf.Tv)
            tauMv = _host(idf.tauMeasuredValidation)
            tauEv = _host(idf.tauEstimatedValidation)
            for j in range(m.num_dofs):
                out.append((
                    f"validation {m.jointNames[j]}",
                    Tv,
                    {"measured": tauMv[:, fb + j], "predicted": tauEv[:, fb + j]},
                ))
        return out

    def render_tikz(self, filename: str | None = None, max_points: int = 400) -> str:
        """pgfplots (TikZ) export of the torque plots (reference
        output.py:916-960 used matplotlib2tikz; here the TikZ source is
        emitted directly from the datasets — no converter dependency)."""
        parts = ["% generated by flobaroid_tpu_torch", "\\begin{tikzpicture}"]
        for gi, (title, T, series) in enumerate(self._datasets()):
            step = max(1, len(T) // max_points)
            parts.append(
                f"\\begin{{axis}}[title={{{title}}},width=0.9\\linewidth,height=4.5cm,"
                f"xlabel={{time [s]}},ylabel={{torque [Nm]}},legend pos=outer north east,"
                f"at={{(0,{-gi * 5.2}cm)}},anchor=north west]"
            )
            for label, y in series.items():
                coords = " ".join(
                    f"({T[i]:.4g},{y[i]:.6g})" for i in range(0, len(T), step)
                )
                parts.append(f"\\addplot+[mark=none] coordinates {{{coords}}};")
                parts.append(f"\\addlegendentry{{{label}}}")
            parts.append("\\end{axis}")
        parts.append("\\end{tikzpicture}")
        tex = "\n".join(parts)
        if filename:
            with open(filename, "w") as f:
                f.write(tex)
            print(f"Saved TikZ plot to {filename}")
        return tex

    def _plotly_html(self) -> str | None:
        """Interactive plotly report when plotly is importable
        (reference output.py:775-805); None -> caller falls back to
        the self-contained matplotlib-SVG report."""
        try:
            import plotly.graph_objects as go
            from plotly.subplots import make_subplots
        except ImportError:
            return None
        ds = self._datasets()
        ncols = 3
        nrows = int(np.ceil(len(ds) / ncols))
        fig = make_subplots(rows=nrows, cols=ncols,
                            subplot_titles=[t for t, _, _ in ds])
        for i, (title, T, series) in enumerate(ds):
            r, c = i // ncols + 1, i % ncols + 1
            for label, y in series.items():
                fig.add_trace(
                    go.Scatter(x=T, y=y, name=label, showlegend=(i == 0)),
                    row=r, col=c,
                )
        fig.update_layout(height=300 * nrows, title="flobaroid_tpu_torch identification report")
        html = fig.to_html(include_plotlyjs=True)
        if self.text:
            html = html.replace(
                "</body>", f"<pre>{self.text.replace('<', '&lt;')}</pre></body>"
            )
        return html

    def _svg_html(self) -> str:
        import matplotlib.pyplot as plt

        parts = [
            "<!DOCTYPE html><html><head><meta charset='utf-8'>",
            "<title>flobaroid_tpu_torch identification report</title>",
            "<style>body{font-family:sans-serif;margin:2em;}"
            "pre{background:#f6f6f6;padding:1em;overflow-x:auto;font-size:12px;}"
            "h2{border-bottom:1px solid #ccc;}</style></head><body>",
            "<h1>Identification report</h1>",
        ]
        for title, fig in self._figures():
            buf = io.StringIO()
            fig.savefig(buf, format="svg")
            plt.close(fig)
            parts.append(f"<h2>{title}</h2>")
            parts.append(buf.getvalue())
        if self.text:
            parts.append("<h2>Console output</h2><pre>")
            parts.append(self.text.replace("<", "&lt;"))
            parts.append("</pre>")
        parts.append("</body></html>")
        return "\n".join(parts)

    def render(self, filename: str | None = None) -> str:
        opt = self.idf.opt
        out = filename or opt.get("outputFilename") or "output.html"
        html = None
        if opt.get("outputAs", "html") == "html":
            # interactive plotly report when available, SVG fallback
            # (reference output.py:775-805 plotly-offline semantics);
            # the matplotlib figure set is only built when actually used
            html = self._plotly_html()
            if html is None:
                html = self._svg_html()
            with open(out, "w") as f:
                f.write(html)
            print(f"Saved report to {out}")
        elif opt.get("outputAs") == "tikz":
            tex_out = out if out.endswith(".tex") else out.rsplit(".", 1)[0] + ".tex"
            self.render_tikz(tex_out)
        elif opt.get("outputAs") == "pdf":
            # PDF via matplotlib's PdfPages
            import matplotlib.pyplot as plt
            from matplotlib.backends.backend_pdf import PdfPages

            pdf_out = out if out.endswith(".pdf") else out.rsplit(".", 1)[0] + ".pdf"
            with PdfPages(pdf_out) as pdf:
                for _, fig in self._figures():
                    pdf.savefig(fig)
                    plt.close(fig)
            print(f"Saved report to {pdf_out}")
        elif opt.get("outputAs") == "interactive":
            for _, fig in self._figures():
                fig.show()
        return html

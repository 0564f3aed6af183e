"""Identify inertial + friction parameters from measurements.

    python -m flobaroid_tpu_torch.cli.identifier --config CFG --model URDF \
        --measurements meas.npz [--validation val.npz] [--model_real URDF] \
        [--model_output out.urdf] [--trajectory traj.npz] [--plot] [--device cpu]

Counterpart of the JAX package's root identifier.py (reference
identifier.py main, :1441-1616): loads config + URDF + measurement npz
files, optionally merges unobservable params from the trajectory file
into dontChangeParams, runs the (optionally block-selecting)
identification on the device, validates on held-out data, renders the
console and HTML reports, and exports the identified model to URDF when
physically consistent.
"""

from __future__ import annotations

import numpy as np

from ..utils.cli import base_parser, load_cli_config, setup_device


def parse_args(argv=None):
    p = base_parser("Identify dynamics parameters from measurements",
                    prog="python -m flobaroid_tpu_torch.cli.identifier")
    p.add_argument("--measurements", action="append", nargs="+", required=True,
                   help="measurements npz file(s), repeatable")
    p.add_argument("--validation", "--verification", "--verify",
                   help="measurements npz for validation")
    p.add_argument("--model_real", help="URDF with ground-truth params (simulation)")
    p.add_argument("-o", "--model_output", "--output",
                   help="write identified URDF here")
    p.add_argument("--trajectory", help="trajectory npz (for unobservable params)")
    p.add_argument("--plot", action="store_true", help="create plots")
    return p.parse_args(argv)


def merge_unobservable(config: dict, trajectory_file: str) -> None:
    """Pin the trajectory file's unobservable params to their a-priori
    values through dontChangeParams (reference identifier.py:1536-1562)."""
    try:
        with np.load(trajectory_file, allow_pickle=True) as f:
            if "unobservable_params" in f.files:
                unobs = [int(v) for v in f["unobservable_params"]]
                if unobs:
                    cur = set(config.get("dontChangeParams", []))
                    config["dontChangeParams"] = sorted(cur | set(unobs))
                    print(f"pinning {len(unobs)} unobservable params to a priori")
    except (OSError, KeyError) as e:
        print(f"could not read trajectory file: {e}")


def urdf_friction(idf, config: dict, xStd: np.ndarray) -> dict | None:
    """Per-joint <dynamics friction/damping> of the identified model: the
    post-identification refit, else the simultaneously identified
    symmetric Coulomb and viscous columns, else None."""
    m = idf.model
    if hasattr(idf, "postid_friction"):
        return {
            m.jointNames[j]: {
                "friction": idf.postid_friction["Fc"][j],
                "damping": idf.postid_friction["Fv"][j],
            }
            for j in range(m.num_dofs)
        }
    if config["identifyFrictionSimultaneously"] and config["identifySymmetricVelFriction"]:
        fs, nd = m.friction_params_start, m.num_dofs
        return {
            m.jointNames[j]: {"friction": xStd[fs + j], "damping": xStd[fs + nd + j]}
            for j in range(nd)
        }
    return None


def main(argv=None):
    args = parse_args(argv)
    device = setup_device(args)
    config = load_cli_config(args)

    from ..identification.identifier import Identification, score_blocks
    from ..output import OutputConsole, OutputMatplotlib
    from ..utils import helpers
    from ..utils.timing import stage_timer, torch_profile

    if args.trajectory:
        merge_unobservable(config, args.trajectory)

    with stage_timer("model + projections", config):
        idf = Identification(
            config,
            config["urdf"],
            urdf_file_real=args.model_real,
            measurements_files=args.measurements,
            regressor_file=config.get("regressor"),
            validation_file=args.validation,
            device=device,
        )

    if config.get("filterMeasurements", 0) or config.get("preprocessMeasurements", 1):
        # raw hardware data needs the filtering/differentiation chain;
        # files written by the simulator carry *_raw + filtered channels
        # already, so only preprocess when requested or raw-only
        if "velocities_raw" not in idf.data.samples or config.get("filterMeasurements", 0):
            idf.data.preprocess()

    if config.get("removeNearZero", 0):
        idf.data.remove_near_zero_samples()

    if config.get("selectBlocksFromMeasurements", 0):
        # Venture-2009 block selection (reference identifier.py:1564-1589;
        # needs materializeRegressor=1)
        conds, _ = score_blocks(idf)
        print(f"selected blocks: {idf.data.selected_blocks} "
              f"(conds {['%.3g' % c for c in conds]})")

    with torch_profile(config.get("jaxProfileDir")), stage_timer("estimation", config):
        idf.estimateParameters()

    if config.get("showMemUsage", 0):
        from ..utils.timing import print_mem_usage

        print_mem_usage(
            dict(
                YStd=idf.model.YStd,
                YBase=idf.model.YBase,
                G_rows=getattr(idf.model, "G_rows", None),
                tauMeasured=idf.model.tauMeasured,
                samples=idf.data.samples,
            )
        )

    # validation runs BEFORE rendering so the console/report can show
    # val_error/val_residual/val_nrms (reference identifier.py:303-320)
    if args.validation:
        idf.estimateValidationTorques()

    console = OutputConsole(idf)
    text = console.render()

    if config.get("outputLatex", 0):
        print(console.render_latex())

    if args.plot or config.get("createPlots", 0):
        OutputMatplotlib(idf, text=text).render()

    if args.model_output:
        m = idf.model
        xStd = idf._full_xstd()
        if helpers.is_physical_consistent(xStd[: m.num_model_params], m.num_links):
            from ..models.urdf import replace_params_in_urdf

            replace_params_in_urdf(
                config["urdf"], args.model_output, xStd[: m.num_model_params],
                m.linkNames, friction=urdf_friction(idf, config, xStd),
            )
            print(f"Wrote identified model to {args.model_output}")
        else:
            print("identified params are not physically consistent — NOT writing URDF "
                  "(enable constrainToConsistent for guaranteed-consistent output)")

    return idf


if __name__ == "__main__":
    main()

"""YAML configuration of the port (counterpart of flobaroid_tpu/utils/config.py).

`DEFAULTS` is a copy of the JAX package's table (a test keeps the two
equal). PyYAML is imported only inside `load_config` when a file is
read: a run configured from a dict needs no YAML package.
"""

from __future__ import annotations

from typing import Any

# Defaults for every documented key. Values mirror the reference's
# implicit/explicit defaults (configs/*.yaml and scattered .get calls).
DEFAULTS: dict[str, Any] = {
    # ---- trajectory generation / excitation ----
    "optimizeTrajectory": 1,
    "useGlobalOptimization": 1,
    "globalOptIterations": 20,
    "globalOptSize": 256,
    "globalOptRestarts": 2,
    "useLocalOptimization": 1,
    "localOptIterations": 10,
    "localOptStages": 6,
    # independent AL restarts advanced as one vmapped batch (sharded
    # over the candidate mesh axis when shardCandidates > 1); 1 keeps
    # the classic single-start refinement
    "localOptRestarts": 1,
    # HBM guards: candidate-batch chunk for the vmapped objective /
    # AL tape (TPU tile padding inflates the tiny trailing regressor
    # dims 17-57x, so full-population vmaps OOM at scale)
    "evalBatchChunk": 8,
    "alBatchChunk": 2,
    "minTolConstr": 0.01,
    # display/interactive toggles accepted for reference-config compat;
    # headless no-ops here (reports are written as files instead)
    "showOptimizationGraph": 0,
    "showOptimizationTrajs": 0,
    "showModelVisualization": 0,
    "transparentLinks": [],
    "ignoreLinksForCollision": [],
    "ignoreLinkPairsForCollision": [],
    "checkCollisions": 1,
    "collisionCheckStep": 3,
    "transitionCollisionSamples": 10,
    "transitionDuration": 3.0,
    "worldUrdf": None,
    "trajectoryPulseInit": 0.5,
    "trajectoryPulseMin": 0.3,
    "trajectoryPulseMax": 1.0,
    "trajectoryCoeffInit": 0.4,
    "trajectoryCoeffMin": -0.5,
    "trajectoryCoeffMax": 0.5,
    # scalar, or {jointName: value} for per-joint excitation targets
    # (also trajectoryTargetTorqueUtil and minVelocityPercentage)
    "trajectoryTargetVelocity": 0.0,
    "globalOptAmplitudeRepair": 1,
    "trajectorySeedSolutions": [],
    "trajectoryPriorMeasurements": [],
    "trajectoryCenterFreedom": 25.0,
    "trajectoryOscillationCenters": {},
    "trajectoryNf": {},
    "trajectoryDefaultNf": 4,
    "ovrPosLimit": {},
    "minVelocityConstraint": 0,
    "minVelocityPercentage": 0.1,
    "minTorqueConstraint": 0,
    "minTorquePercentage": 0.1,
    "doptRegularization": 1e-4,
    "useStaticTrajectories": 0,
    "numStaticPostures": 5,
    "scaleCollisionHull": 1.0,
    "staticPostureTime": 0.02,
    "initialPostures": [],
    "exciteMethod": None,
    "ros_move_group": "",
    "excitationFrequency": 200.0,
    "useDeg": 0,
    # collision
    "collisionMode": "capsule",
    "fullMeshLinks": [],
    "ignoreCollisionBetweenGroups": [],  # [[groupA...],[groupB...]] pairs to skip
    "maxKinematicDistance": 0,
    "worldCollisionMargins": {},
    # suspended base
    "floatingBaseAttachmentFrame": "",
    "suspendedDamping": 5.0,
    # ---- data preprocessing ----
    "filterMedianSize": 11,
    "filterLowPass1": [8.0, 5],
    "filterLowPass2": [6.0, 5],
    "filterLowPass3": [3.0, 4],
    "startOffset": 0,
    "skipSamples": 0,
    "selectBlocksFromMeasurements": 0,
    "blockSize": 250,
    "selectBestPerenctage": 50,  # (sic — reference key is misspelled)
    "removeNearZero": 0,
    "minVel": 0.01,
    "waitForZeroAcc": 0,
    "zeroAccThresh": 0.1,
    # ---- identification ----
    "useStructuralRegressor": 1,
    "randomSamples": 2000,
    "minTol": 1e-4,
    "floatingBase": 0,
    "identifyFrictionSimultaneously": 0,
    "identifySymmetricVelFriction": 1,
    "identifyGravityParamsOnly": 0,
    "simulateTorques": 0,
    "useBaseWrenchForBaseParams": 0,
    "useTrajectoryWeighting": 0,
    "postIdentifyFriction": 0,
    "frictionSignThreshold": 0.02,
    "frictionVelocityCutoff": 25.0,
    "frictionSwerversDeadZone": 0.0,
    "frictionFvRegularization": 0.0,
    "frictionFvRegularizationRelative": 0.0,
    "stribeckVelocity": 0.0,
    # SDP
    "constrainToConsistent": 0,
    "checkAPrioriFeasibility": 0,
    "identifyClosestToCAD": 0,
    "noChange": 0,
    "noChangeThresh": 400,
    "restrictCOMtoHull": 0,
    "hullScaling": 1.0,
    "meshBaseDir": "meshes",
    "cubeSize": 0.5,
    "limitCOMToApriori": 0,
    "limitCOMAprioriBoundary": 0.005,
    "limitOverallMass": 0,
    "limitMassVal": None,
    "limitMassRange": 0.5,
    "limitMassToApriori": 0,
    "limitMassAprioriBoundary": 0.2,
    "dontChangeParams": [],
    "dontChangeLinks": [],
    "dontConstrain": [],
    "useSymmetryConstraints": 0,
    "symmetryTolerance": 0.05,
    "cadRegularizationMode": "uniform",  # 'uniform'|'observability'|'geometric'
    # other estimation
    "useAPriori": 0,
    "useEssentialParams": 0,
    "useDependents": 0,
    "useWLS": 0,
    "filterRegressor": 0,
    "filterRegCutoff": 5,
    "estimateWith": "std",
    # ---- output / debugging ----
    "createPlots": 0,
    "outputModule": "matplotlib",
    "outputAs": "html",
    "outputFilename": None,
    "plotBaseDynamics": 1,
    "plotPerJoint": 1,
    "plotPrioriTorques": 1,
    "plotErrors": 0,
    "showRandomRegressor": 0,
    "showErrorHistogram": 0,
    "showMemUsage": 0,
    "showTiming": 0,
    "showEssentialSteps": 0,
    "outputBarycentric": 0,
    "showStandardParams": 1,
    "showBaseParams": 1,
    "showBaseEqns": 0,
    "outputLatex": 0,
    "showTriangleConsistency": 0,
    "verbose": 0,
    # ---- hidden experiment flags (reference identifier.py:55-69) ----
    "useBasisProjection": 0,
    "orthogonalizeBasis": 1,
    "useRegressorRegularization": 1,
    "regularizationFactor": 1000.0,
    "deleteFixedBase": 1,
    # ---- tpu-native execution options (new) ----
    "computeDtype": "float32",  # on-device regressor/Gram dtype
    "gramChunk": 4096,  # samples per on-device Gram accumulation chunk
    "materializeRegressor": 1,  # keep the stacked YStd (else stream Gram only)
    # streaming mode: keep the built regressor chunks device-resident so
    # reporting/WLS contractions reuse them (-1 auto: when Y <= 2 GB)
    "cacheRegressorDevice": -1,
    "shardSamples": 0,  # shard the sample axis over the device mesh
    "shardCandidates": 0,  # shard global-search candidate batches over devices
    # mid-optimization checkpoint/resume for the trajectory optimizer
    # (beyond the reference, which only checkpoints stage outputs)
    "trajectoryCheckpointFile": "",
    "jaxProfileDir": None,  # capture a JAX device profile of the estimation
    # ---- remaining reference keys (wired round 2) ----
    # None = "not set": code falls back to this repo's earlier spelling
    # (maxKinematicDistance / minTorqueConstraint+minTorquePercentage)
    "collisionMaxKinematicDistance": None,
    "scaleCapsuleRadius": 1.0,  # capsule-mode radius scale (reference optimizer.py:538)
    "minTorqueUtilization": None,  # hard per-joint torque-utilization floor
    "simulateNumStops": 0,  # sudden stops inserted into the sampled trajectory
    "staticPostures": None,  # explicit posture list -> played back directly
    "simulateStaticSamplesPerPosture": None,  # hold samples per static posture
    "trajectoryBounded": 1,  # tanh-bounded Fourier (0: classic pulsed series)
    "geometricObservabilityWeighting": 0,  # geo prior x observability (geo+obs)
}

# Reference keys that configure machinery this rebuild replaced outright
# (FD gradients + multiprocessing pools -> jax.grad; Optuna worker
# processes -> vmapped candidate batches / shardCandidates; cvxpy solver
# selection -> the in-repo barrier solver). Accepted and ignored, with a
# one-line notice so nobody is silently surprised.
OBSOLETE_REFERENCE_KEYS = {
    "analyticalGradientEpsilon", "analyticalGradientJobs",
    "useAnalyticalGradients", "globalOptJobs", "optunaSampler",
    "localOptSensStep", "sdpSolver", "sdpSolverOptions",
}


def load_config(path: str | None = None, overrides: dict | None = None) -> dict[str, Any]:
    """Load a reference-format YAML config, fill defaults, apply overrides."""
    cfg = dict(DEFAULTS)
    if path is not None:
        import yaml

        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        if not isinstance(loaded, dict):
            raise ValueError(f"config {path} did not parse to a mapping")
        obsolete = sorted(OBSOLETE_REFERENCE_KEYS.intersection(loaded))
        if obsolete and loaded.get("verbose", cfg.get("verbose", 0)):
            print(
                "config: reference keys with no effect in this rebuild "
                f"(superseded by autodiff/vmap/in-repo solver): {obsolete}"
            )
        cfg.update(loaded)
    if overrides:
        cfg.update(overrides)
    return cfg

__version__ = "2.0"

"""Meshroom node for the PyTorch/CUDA RNb-NeuS2 pipeline.

Counterpart of the reference's Meshroom plugin (meshroom/RNb-NeuS2/
RNbNeuS2.py) with the parameter surface of the JAX package's node: the
normal, albedo and mask SfMData, the mask folder, the training and scaling
parameters, and mesh.obj in world coordinates in the node's cache folder.
No testbed binary is needed: `processChunk` calls this package's
`cli.pipeline.run_full_pipeline`, which runs on the CUDA card. `useTpu`
keeps the JAX node's name and is informational here as it is there.

Install: add this directory to MESHROOM_NODES_PATH; the repository root
must be on PYTHONPATH so that `rnb_neus2_torch` imports.
"""

from meshroom.core import desc

try:
    from meshroom.core.utils import VERBOSE_LEVEL
except Exception:  # older meshroom
    VERBOSE_LEVEL = ["fatal", "error", "warning", "info", "debug", "trace"]


class RNbNeuS2Torch(desc.Node):
    """Neural surface reconstruction from normal/albedo maps (CUDA)."""

    category = "Neural Reconstruction"
    gpu = desc.Level.INTENSIVE
    size = desc.DynamicNodeSize("inputNormalSfm")

    documentation = """
Neural surface reconstruction from multi-view normal maps on an NVIDIA
card (PyTorch/CUDA implementation of RNb-NeuS2).

**Inputs:** normal-map SfMData (required); albedo SfMData (optional,
enables two-phase training with multi-view albedo scaling); mask SfMData
or folder.

**Output:** OBJ mesh in world coordinates.
"""

    inputs = [
        desc.File(name="inputNormalSfm", label="Normal Maps SfMData",
                  description="SfMData file pointing to normal maps.",
                  value=""),
        desc.File(name="inputAlbedoSfm", label="Albedo Maps SfMData",
                  description="SfMData for albedos; enables two-phase "
                              "training with albedo scaling.", value=""),
        desc.File(name="inputMaskSfm", label="Mask SfMData",
                  description="SfMData pointing to mask images.", value=""),
        desc.File(name="inputMaskFolder", label="Mask Folder",
                  description="Folder with per-view masks (viewId in "
                              "filename); ignored when Mask SfMData is "
                              "set.", value=""),
        desc.IntParam(name="maxSteps", label="Max Training Steps",
                      description="Stage-2 iterations; stage 1 uses 2/3.",
                      value=15000, range=(1000, 100000, 1000)),
        desc.IntParam(name="meshResolution", label="Mesh Resolution",
                      description="Marching-cubes grid resolution.",
                      value=1024, range=(128, 2048, 128)),
        desc.ChoiceParam(name="scalingMode", label="Scaling Mode",
                         description="Scene normalization strategy.",
                         values=["auto", "pcd", "silhouettes",
                                 "silhouettes_v2", "cameras", "none"],
                         value="auto"),
        desc.FloatParam(name="sphereScale", label="Sphere Scale",
                        description="Target radius in normalized space.",
                        value=1.0, range=(0.1, 2.0, 0.05)),
        desc.FloatParam(name="warmupRatio", label="Phase 1 Ratio",
                        description="Geometry-only warmup fraction "
                                    "(albedo mode).",
                        value=0.1, range=(0.01, 1.0, 0.01)),
        desc.FloatParam(name="maskWeight", label="Mask Weight",
                        description="Silhouette BCE loss weight.",
                        value=1.0, range=(0.0, 10.0, 0.1)),
        desc.BoolParam(name="superNormal", label="SuperNormal",
                       description="Identity light triplet mode.",
                       value=False),
        desc.BoolParam(name="useL1", label="L1 Norm",
                       description="L1 color loss instead of L2.",
                       value=False),
        desc.BoolParam(name="useRgbPlus", label="RGB+",
                       description="4th singularity-breaking albedo "
                                   "channel.", value=True),
        desc.BoolParam(name="useTpu", label="Use Accelerator",
                       description="Informational; computation runs on "
                                   "the CUDA card.", value=True),
        desc.ChoiceParam(name="verboseLevel", label="Verbose Level",
                         description="Verbosity.", values=VERBOSE_LEVEL,
                         value="info"),
    ]

    outputs = [
        desc.File(name="outputFolder", label="Output Folder",
                  description="Working/cache folder.",
                  value="{nodeCacheFolder}"),
        desc.File(name="outputMesh", label="Output Mesh",
                  description="Reconstructed mesh (world coordinates).",
                  value="{nodeCacheFolder}/mesh.obj"),
    ]

    def processChunk(self, chunk):
        from rnb_neus2_torch.cli.pipeline import run_full_pipeline

        a = chunk.node
        chunk.logManager.start(a.verboseLevel.value)
        try:
            run_full_pipeline(
                input_path=a.inputNormalSfm.value,
                output_dir=a.outputFolder.value,
                max_steps=a.maxSteps.value,
                mesh_resolution=a.meshResolution.value,
                scaling_mode=a.scalingMode.value,
                sphere_scale=a.sphereScale.value,
                warmup_ratio=a.warmupRatio.value,
                mask_weight=a.maskWeight.value,
                super_normal=a.superNormal.value,
                use_l1=a.useL1.value,
                use_rgb_plus=a.useRgbPlus.value,
                has_albedo=bool(a.inputAlbedoSfm.value),
                albedo_sfm_path=a.inputAlbedoSfm.value,
                mask_sfm_path=a.inputMaskSfm.value,
                mask_folder_path=a.inputMaskFolder.value,
                logger=chunk.logger,
            )
        finally:
            chunk.logManager.end()

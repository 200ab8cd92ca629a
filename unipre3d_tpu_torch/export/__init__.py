"""Export of the port's weights under the reference's torch names, and
their import (the warm start). Counterpart of unipre3d_tpu/export, with the
same public names; ``export_predictor`` dispatches a whole model's
``state_dict`` by backbone, as the export CLI does."""

from unipre3d_tpu_torch.export.torch_export import (export_ptv3_backbone,
                                                    export_scene_predictor,
                                                    export_sparseunet_backbone,
                                                    export_state_dict,
                                                    export_transformer_predictor,
                                                    import_ptv3_backbone,
                                                    import_sparseunet_backbone,
                                                    import_transformer_backbone,
                                                    save_torch_checkpoint)
from unipre3d_tpu_torch.export.object_backbones import (
    EXPORTERS, IMPORTERS, export_mamba3d_backbone, export_pcm_backbone,
    export_pointmlp_backbone, import_mamba3d_backbone, import_pcm_backbone,
    import_pointmlp_backbone)
from unipre3d_tpu_torch.weights import state_dict_to_jax


def export_predictor(state_dict, backbone: str, full: bool = False):
    """A ``GaussianSplatPredictor``'s ``state_dict`` -> the reference-named
    state dict of numpy arrays, dispatched as the repository's
    ``export_checkpoint.py`` does: the transformer's whole predictor, the
    scene predictor for ``sparseunet`` / ``ptv3``, the encoder alone under
    ``point_network.encoder`` for ``pointmlp`` / ``mamba3d`` / ``pcm``, and
    the generic flattened export with ``full`` or any other backbone."""
    params, stats = state_dict_to_jax(state_dict)
    if full:
        return export_state_dict(params, stats)
    if backbone == "transformer":
        return export_transformer_predictor(params, stats)
    if backbone in ("sparseunet", "ptv3"):
        return export_scene_predictor(params, stats, backbone)
    if backbone in EXPORTERS:
        return EXPORTERS[backbone](params["point_network"]["encoder"],
                                   stats.get("point_network", {}).get(
                                       "encoder", {}),
                                   prefix="point_network.encoder")
    return export_state_dict(params, stats)

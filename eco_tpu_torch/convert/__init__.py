from eco_tpu_torch.convert.caffemodel import load_blobproto, load_caffemodel
from eco_tpu_torch.convert.export import (
    export_serving,
    load_serving_artifact,
    save_serving_artifact,
)
from eco_tpu_torch.convert.bridge import params_from_jax, params_to_jax
from eco_tpu_torch.convert.load import (
    convert_conv_weight,
    fold_bn,
    fold_input_transform,
    fold_space_to_depth,
    import_caffe_weights,
)
from eco_tpu_torch.convert.quantize import (
    calibrate,
    chain_int8,
    int8_input_rewrite,
    quantize_for_serving,
    quantize_graph,
)
from eco_tpu_torch.spec.transforms import merge_sibling_1x1_convs


def optimize_for_inference(graph, params, state, *, fold: bool = True,
                           merge: bool = True):
    """Inference-graph optimization pipeline: sibling-1x1 merge, then the
    folds of BN and of an input transform into the convolutions, and a 3D
    stride-2 convolution over a few channels run as space-to-depth."""
    if merge:
        graph, params, state = merge_sibling_1x1_convs(graph, params, state)
    if fold:
        graph, params, state = fold_bn(graph, params, state)
        graph, params, state = fold_input_transform(graph, params, state)
        graph, params, state = fold_space_to_depth(graph, params, state)
    return graph, params, state

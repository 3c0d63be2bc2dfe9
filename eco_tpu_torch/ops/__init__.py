from eco_tpu_torch.ops.attention import pad_tokens, patch_merging, window_attention
from eco_tpu_torch.ops.conv import conv2d, conv3d, conv_nd
from eco_tpu_torch.ops.elementwise import (
    bnll,
    concat_channels,
    dropout,
    eltwise,
    gelu,
    lrn,
    mvn,
    relu,
    threshold,
)
from eco_tpu_torch.ops.layout import (
    caffe_reshape_dims,
    fold_segments,
    im2col,
    segment_consensus,
    to_logical,
    to_physical,
    unfold_segments,
)
from eco_tpu_torch.ops.linear import inner_product
from eco_tpu_torch.ops.loss import (
    contrastive_loss,
    euclidean_loss,
    hinge_loss,
    infogain_loss,
    multinomial_logistic_loss,
    sigmoid_cross_entropy,
    smooth_l1_loss,
    softmax,
    softmax_cross_entropy,
    topk_accuracy,
)
from eco_tpu_torch.ops.norm import (
    bn_inference,
    bn_train,
    fold_scale_shift,
    layer_norm,
    scale_shift,
)
from eco_tpu_torch.ops.pool import (
    avg_pool,
    global_avg_pool,
    max_pool,
    pool_nd,
    roi_max_pool,
    stochastic_pool,
)
from eco_tpu_torch.ops.poolfuse import fused_maxpool_3x3s2
from eco_tpu_torch.ops.pooled_attention import pool_skip, pooled_size, prepend_token
from eco_tpu_torch.ops.preprocess import preprocess_on_device
from eco_tpu_torch.ops.s2d import space_to_depth
from eco_tpu_torch.ops.quant import (
    conv_nd_int8,
    inner_product_int8,
    quantize_act,
    quantize_weight,
)

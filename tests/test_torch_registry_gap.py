"""The port's gap to the reference, as a checked fact: the forward op
types the reference registers and the port does not (ROADMAP.md Queue A
9b-9i), and the public ``fluid.layers`` names it lacks (9b, 9d, 9e and
the reference's doc and generator helpers), each listed by name.  A
later slice that ports some of them takes them off these lists.  The
fusion pass's activation and lookup families name only registered op
types, so a fused program never reaches an unported op."""

import paddle_tpu.layers as j_layers
from paddle_tpu.ops import registry as j_registry

import paddle_tpu_torch.layers as t_layers
from paddle_tpu_torch.ops import registry as t_registry
from paddle_tpu_torch.static_analysis import fusion as tfusion

MISSING_OP_TYPES = set("""
anchor_generator attention_lstm bipartite_match box_clip box_coder
box_decoder_and_assign chunk_eval collect_fpn_proposals
conv2d_fusion conv2d_inception_fusion conv_shift cos_sim
crf_decoding cross_entropy2 ctc_align cudnn_lstm cvm
density_prior_box depthwise_conv2d_transpose dequantize
detection_map distribute_fpn_proposals dynamic_lstmp edit_distance
fake_channel_wise_dequantize_max_abs
fake_channel_wise_quantize_abs_max
fake_channel_wise_quantize_dequantize_abs_max
fake_dequantize_max_abs fake_init fake_quantize_abs_max
fake_quantize_dequantize_abs_max
fake_quantize_dequantize_moving_average_abs_max
fake_quantize_moving_average_abs_max fake_quantize_range_abs_max
fill fill_zeros_like2 fused_elemwise_activation
fused_embedding_fc_lstm fused_embedding_seq_pool fusion_gru
fusion_lstm fusion_repeated_fc_relu fusion_seqconv_eltadd_relu
fusion_seqexpand_concat_fc fusion_seqpool_concat
fusion_squared_mat_sub fusion_transpose_flatten_concat
generate_mask_labels generate_proposal_labels generate_proposals
get_places get_tensor_from_selected_rows hinge_loss iou_similarity
l1_norm linear_chain_crf load load_combine lstmp
max_pool2d_with_index max_pool3d_with_index merge_ids
merge_selected_rows mine_hard_examples minus modified_huber_loss
moving_average_abs_max_scale multiclass_nms multiclass_nms2 norm
polygon_box_transform prior_box py_func quantize
quantize_dequantize_fixed_scale requantize
retinanet_detection_output retinanet_target_assign roi_align
roi_perspective_transform rpn_target_assign sample_logits save
save_combine sequence_concat sequence_enumerate sequence_erase
sequence_expand sequence_expand_as sequence_pad sequence_reshape
sequence_reverse sequence_scatter sequence_slice sequence_softmax
sequence_unpad sigmoid_focal_loss similarity_focus split_ids
split_selected_rows spp squared_l2_distance ssd_loss target_assign
unpool warpctc yolo_box yolov3_loss
""".split())

MISSING_LAYERS = {
    # 9b: sequence, CRF, CTC, LSTMP
    "9b": set("""
chunk_eval crf_decoding ctc_greedy_decoder dynamic_lstmp
edit_distance linear_chain_crf lstm lstm_unit sequence_concat
sequence_enumerate sequence_expand sequence_expand_as
sequence_first_step sequence_last_step sequence_pad sequence_reshape
sequence_reverse sequence_scatter sequence_slice sequence_softmax
sequence_unpad warpctc
""".split()),
    # 9d: detection
    "9d": set("""
anchor_generator bipartite_match box_clip box_coder
box_decoder_and_assign collect_fpn_proposals density_prior_box
detection detection_extra detection_output distribute_fpn_proposals
generate_mask_labels generate_proposal_labels generate_proposals
iou_similarity multi_box_head multiclass_nms polygon_box_transform
prior_box retinanet_detection_output retinanet_target_assign
roi_align roi_perspective_transform rpn_target_assign
sigmoid_focal_loss ssd_loss target_assign yolo_box yolov3_loss
""".split()),
    # 9e: the rest of the layers
    "9e": set("""
adaptive_pool2d adaptive_pool3d continuous_value_model cos_sim
get_tensor_from_selected_rows load merge_selected_rows py_func
similarity_focus
""".split()),
    # the reference's doc and layer-generator helpers
    "helpers": set("""
autodoc cond_not_supported deprecated generate_activation_fn
generate_layer_fn layer_function_generator templatedoc
""".split()),
}


def _forward_types(registry):
    return {t for t in registry._OP_REGISTRY if not t.endswith("_grad")}


def _public(module):
    return {n for n in dir(module) if not n.startswith("_")}


def test_missing_op_types_are_exactly_the_listed_ones():
    gap = _forward_types(j_registry) - _forward_types(t_registry)
    assert len(MISSING_OP_TYPES) == 108
    assert gap == MISSING_OP_TYPES, (sorted(gap - MISSING_OP_TYPES),
                                     sorted(MISSING_OP_TYPES - gap))


def test_the_port_registers_no_op_type_the_reference_lacks():
    assert _forward_types(t_registry) <= _forward_types(j_registry)


def test_missing_layer_names_are_exactly_the_listed_ones():
    listed = set().union(*MISSING_LAYERS.values())
    assert [len(MISSING_LAYERS[q]) for q in ("9b", "9d", "9e", "helpers")] \
        == [22, 29, 9, 7]
    gap = _public(j_layers) - _public(t_layers)
    assert gap == listed, (sorted(gap - listed), sorted(listed - gap))


def test_fusion_families_name_registered_op_types():
    for t in tfusion._ACT_TYPES + tfusion._LOOKUP_OP_TYPES:
        assert t_registry.has_op(t) and t_registry.has_op(t + "_grad"), t

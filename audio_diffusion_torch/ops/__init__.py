from .attention import Attention, AttentionItem, CrossAttentionItem, FeedForward
from .components import AppendChannelsPlugin, LTPlugin, UNetV0, XUNet
from .net import Net, cast_inference_params

__all__ = ["UNetV0", "XUNet", "Net", "cast_inference_params", "Attention",
           "AttentionItem", "CrossAttentionItem", "FeedForward", "LTPlugin",
           "AppendChannelsPlugin"]

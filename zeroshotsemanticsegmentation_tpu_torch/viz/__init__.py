"""Segmentation visualization: colormaps, tiles, image files."""

from zeroshotsemanticsegmentation_tpu_torch.viz.segmentation import (
    get_tile_image, label2rgb, make_seen_mask, save_image, voc_colormap,
    visualize_seenmask, visualize_segmentation)

__all__ = ["voc_colormap", "label2rgb", "get_tile_image",
           "visualize_segmentation", "visualize_seenmask", "make_seen_mask",
           "save_image"]

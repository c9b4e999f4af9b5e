"""Evaluation metrics: matterport-style AP, Pascal-VOC AP, COCO-style mAP."""

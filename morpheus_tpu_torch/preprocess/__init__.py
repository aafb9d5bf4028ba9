"""Offline preprocessing of a raw RGB-D capture into the training layout
(host code, numpy): pose_init, then virtual_cams."""

"""The port's dataset reader (``vipers_torch.data.detection``) against
``vipers.data.detection``: VOC XML parsing, ground truth with and without
hard boxes, dataset order, a COCO instances json written here (crowd boxes,
an image with no annotation, a 20k-style filename list) and the 20k subset
writer. Everything must be equal."""

import json
import os

import numpy as np
import pytest

from vipers.data import detection as jdet
from vipers_torch.data import detection as tdet

VOC = os.path.join(os.path.dirname(__file__), "data", "torch_voc")


def _same_gt(a, b):
    assert a[1] == b[1]
    assert a[0].shape == b[0].shape
    np.testing.assert_array_equal(a[0], b[0])


@pytest.mark.parametrize("name", ["000005", "000007", "000019"])
def test_parse_voc_xml_and_gt(name):
    path = os.path.join(VOC, "Annotations", f"{name}.xml")
    ann = tdet.parse_voc_xml(path)
    assert ann == jdet.parse_voc_xml(path)
    for hard in (False, True):
        _same_gt(tdet.extract_gt_VOC(ann, remove_hards=hard),
                 jdet.extract_gt_VOC(ann, remove_hards=hard))


def test_voc_without_objects(tmp_path):
    path = tmp_path / "empty.xml"
    path.write_text("<annotation><filename>x.jpg</filename></annotation>")
    ann = tdet.parse_voc_xml(str(path))
    assert ann == jdet.parse_voc_xml(str(path)) and ann["annotation"]["object"] == []
    _same_gt(tdet.extract_gt_VOC(ann), jdet.extract_gt_VOC(ann))


@pytest.mark.parametrize("no_hard", [False, True], ids=["all", "no-hard"])
def test_voc_dataset(no_hard):
    t = tdet.DiscoveryDataset("VOC07", "trainval", VOC, no_hard=no_hard)
    j = jdet.DiscoveryDataset("VOC07", "trainval", VOC, no_hard=no_hard)
    assert list(t) == list(j) and len(t) == len(j) == 8
    for _, name in t:
        _same_gt(t.extract_gt(name), j.extract_gt(name))
    n_hard = sum(len(j.extract_gt(n)[0]) for _, n in j)
    assert n_hard == (8 if no_hard else 10)
    np.testing.assert_array_equal(t.load_image("000009.jpg"), j.load_image("000009.jpg"))


def test_voc_dataset_without_a_set_file(tmp_path):
    os.makedirs(tmp_path / "JPEGImages")
    for n in ("b", "a", "c"):
        (tmp_path / "JPEGImages" / f"{n}.jpg").write_bytes(b"")
    t = tdet.DiscoveryDataset("VOC12", "val", str(tmp_path))
    assert list(t) == list(jdet.DiscoveryDataset("VOC12", "val", str(tmp_path)))
    assert [n for _, n in t] == ["a.jpg", "b.jpg", "c.jpg"]


def _coco(tmp_path):
    images = [{"id": i, "file_name": f"COCO_train2014_{i:012d}.jpg"} for i in (3, 9, 14, 27)]
    anns = [
        {"image_id": 3, "bbox": [10.4, 20.6, 30.5, 40.2], "category_id": 1, "iscrowd": 0},
        {"image_id": 3, "bbox": [1, 2, 3, 4], "category_id": 2, "iscrowd": 1},
        {"image_id": 9, "bbox": [5.5, 6.5, 7.5, 8.5], "category_id": 3},
        {"image_id": 27, "bbox": [0, 0, 12.49, 12.51], "category_id": 4, "iscrowd": 0},
    ]
    path = tmp_path / "instances.json"
    path.write_text(json.dumps({"images": images, "annotations": anns,
                                "categories": [{"id": c} for c in (1, 2, 3, 4)]}))
    sel = tmp_path / "coco_20k.txt"
    sel.write_text("COCO_train2014_000000000003.jpg\nCOCO_train2014_000000000027.jpg\n")
    return str(path), str(sel)


@pytest.mark.parametrize("subset", [False, True], ids=["all", "20k-list"])
def test_coco_dataset(tmp_path, subset):
    ann, sel = _coco(tmp_path)
    kw = dict(coco_annotations=ann, coco20k_list=sel if subset else None)
    t = tdet.DiscoveryDataset("COCO20k", "train", str(tmp_path), **kw)
    j = jdet.DiscoveryDataset("COCO20k", "train", str(tmp_path), **kw)
    assert list(t) == list(j) and len(t) == (2 if subset else 4)
    for _, name in t:
        _same_gt(t.extract_gt(name), j.extract_gt(name))
        assert t.annotation(name) == j.annotation(name)
    with pytest.raises(ValueError, match="coco_annotations"):
        tdet.DiscoveryDataset("COCO20k", "train", str(tmp_path))


def test_select_coco_20k(tmp_path):
    ann, sel = _coco(tmp_path)
    got = tdet.select_coco_20k(sel, ann, str(tmp_path / "t" / "sub.json"))
    want = jdet.select_coco_20k(sel, ann, str(tmp_path / "j" / "sub.json"))
    assert got == want and len(got["images"]) == 2
    assert (tmp_path / "t" / "sub.json").read_text() == (tmp_path / "j" / "sub.json").read_text()


def test_load_image_normalized():
    path = os.path.join(VOC, "JPEGImages", "000012.jpg")
    got, want = tdet.load_image_normalized(path), jdet.load_image_normalized(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)

"""Training-set preparation: ED/ES extraction, QC, train/val/test split.

Counterpart of ``ukbb_cardiac_tpu/data/prepare.py`` (a copy on the
port's NIfTI reader and writer).

Twin of ``data/prepare_data_ukbb2964.py`` restructured into reusable
functions (the reference is a 4-step ``__main__`` script).

Label-completeness requirements per view (``prepare_data_ukbb2964.py:86-97``):
  sa → {0,1,2,3}, la_2ch → {0,1}, la_4ch → {0,1,2}.
ES choice when ≥3 annotated frames: smallest label volume for SA,
largest for LA (``:99-107``).
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from ukbb_cardiac_tpu_torch.io import nifti

REQUIRED_LABELS = {"sa": [0, 1, 2, 3], "la_2ch": [0, 1], "la_4ch": [0, 1, 2]}


def link_annotated_subjects(orig_path: str, data_path: str,
                            seqs=("sa", "la_2ch", "la_4ch")) -> None:
    """Step 1 (``:40-65``): symlink subjects that have cvi42 annotations."""
    os.makedirs(data_path, exist_ok=True)
    for sub in sorted(os.listdir(orig_path)):
        sub_path = os.path.join(orig_path, sub)
        if not os.path.isdir(sub_path):
            continue
        for eid in sorted(os.listdir(sub_path)):
            orig_dir = os.path.join(sub_path, eid)
            if not os.path.exists(os.path.join(orig_dir, f"{eid}_cvi42.zip")):
                continue
            data_dir = os.path.join(data_path, eid)
            os.makedirs(data_dir, exist_ok=True)
            for seq in seqs:
                trio = [f"{seq}.nii.gz", f"label_{seq}.nii.gz",
                        f"label_up_{seq}.nii.gz"]
                if all(os.path.exists(os.path.join(orig_dir, f)) for f in trio):
                    for f in trio:
                        dst = os.path.join(data_dir, f)
                        if not os.path.exists(dst):
                            # absolute target: a cwd-relative source would
                            # be resolved against the LINK's directory and
                            # dangle (silently emptying the training set)
                            os.symlink(os.path.abspath(
                                os.path.join(orig_dir, f)), dst)
            if not os.listdir(data_dir):
                os.rmdir(data_dir)


def find_annotated_ed_es(label: np.ndarray, seq: str) -> Optional[Dict[str, int]]:
    """Step 2 core (``:82-122``): frames with complete annotations; ED must
    be frame 0; ES by min (sa) / max (la) label volume among candidates."""
    proj_t = np.sum(label, axis=(0, 1, 2))
    index_t = []
    required = REQUIRED_LABELS[seq]
    for t in np.nonzero(proj_t)[0]:
        if np.array_equal(np.unique(label[:, :, :, t]), required):
            index_t.append(int(t))
    if len(index_t) >= 3:
        index_ES = index_t[1:]
        if seq == "sa":
            index_t = [index_t[0], index_ES[int(np.argmin(proj_t[index_ES]))]]
        else:
            index_t = [index_t[0], index_ES[int(np.argmax(proj_t[index_ES]))]]
    if proj_t[0] == 0:
        print("  Error: no annotation at ED frame.")
        return None
    if index_t and index_t[0] != 0:
        # conscious fix vs the reference (prepare_data_ukbb2964.py:110):
        # its guard only checks that frame 0 has SOME labels, so a partial
        # annotation at frame 0 would let a mid-cycle frame be used as ED;
        # reject instead (as the JAX package does)
        print("  Error: first complete annotation is not at frame 0.")
        return None
    if len(index_t) == 1:
        print("  Error: annotation only available at one frame.")
        return None
    if len(index_t) != 2:
        print("  Error: annotation not available for two frames.")
        return None
    return {"ED": index_t[0], "ES": index_t[1]}


def extract_ed_es_frames(data_path: str, seqs=("sa", "la_2ch", "la_4ch")) -> None:
    """Step 2 (``:71-137``): write ``<seq>_{ED,ES}`` image/label(+up) files."""
    for seq in seqs:
        for eid in sorted(os.listdir(data_path)):
            data_dir = os.path.join(data_path, eid)
            image_name = os.path.join(data_dir, f"{seq}.nii.gz")
            label_name = os.path.join(data_dir, f"label_{seq}.nii.gz")
            label_up_name = os.path.join(data_dir, f"label_up_{seq}.nii.gz")
            if not os.path.exists(label_name):
                continue
            nim_l = nifti.load(label_name)
            label = np.asanyarray(nim_l.dataobj)
            fr = find_annotated_ed_es(label, seq)
            if fr is None:
                continue
            nim = nifti.load(image_name)
            vol = np.asanyarray(nim.dataobj)
            have_up = os.path.exists(label_up_name)
            if have_up:
                nim_up = nifti.load(label_up_name)
                label_up = np.asanyarray(nim_up.dataobj)
            for k, v in fr.items():
                nifti.save(nifti.Nifti1Image(vol[:, :, :, v], nim.affine),
                           os.path.join(data_dir, f"{seq}_{k}.nii.gz"))
                nifti.save(nifti.Nifti1Image(label[:, :, :, v], nim.affine),
                           os.path.join(data_dir, f"label_{seq}_{k}.nii.gz"))
                if have_up:
                    nifti.save(
                        nifti.Nifti1Image(label_up[:, :, :, v], nim_up.affine),
                        os.path.join(data_dir, f"label_up_{seq}_{k}.nii.gz"))


def quality_control_subjects(data_path: str, seq: str,
                             bad_eids: Sequence[int] = ()) -> List[int]:
    """Step 3 (``:144-180``): both ED/ES image+label present, image not
    blank, minus the manual blacklist."""
    good = []
    for eid in sorted(os.listdir(data_path)):
        data_dir = os.path.join(data_path, eid)
        ok = True
        for fr in ("ED", "ES"):
            image_name = os.path.join(data_dir, f"{seq}_{fr}.nii.gz")
            label_name = os.path.join(data_dir, f"label_{seq}_{fr}.nii.gz")
            if not (os.path.exists(image_name) and os.path.exists(label_name)):
                ok = False
                break
            if np.asanyarray(nifti.load(image_name).dataobj).max() < 1e-6:
                ok = False
                break
        if ok:
            try:
                good.append(int(eid))
            except ValueError:
                pass
    return sorted(set(good) - set(bad_eids))


def split_dataset(data_list: Sequence[int], n_validation: int = 300,
                  n_test: int = 600, icc_list: Sequence[int] = (),
                  seed: Optional[int] = None) -> Dict[str, List[int]]:
    """Step 4 (``:185-212``): train/validation/test split with ICC
    subjects forced into the test set."""
    rng = random.Random(seed)
    icc = sorted(set(icc_list) & set(data_list))
    rest = sorted(set(data_list) - set(icc))
    rng.shuffle(rest)
    n_train = len(data_list) - n_validation - n_test
    return {
        "train": rest[:n_train],
        "validation": rest[n_train:n_train + n_validation],
        "test": rest[n_train + n_validation:] + icc,
    }


def link_split(data_path: str, dest_root: str, seq: str,
               sub_list: Dict[str, List[int]]) -> None:
    """Materialise the split as symlinked subject directories (``:214-223``)."""
    for k, eids in sub_list.items():
        sub_dir = os.path.join(dest_root, seq, k)
        os.makedirs(sub_dir, exist_ok=True)
        for eid in eids:
            src = os.path.join(data_path, str(eid))
            dst = os.path.join(sub_dir, str(eid))
            if not os.path.exists(dst):
                os.symlink(os.path.abspath(src), dst)

"""UK Biobank DICOM → NIfTI conversion.

Counterpart of ``ukbb_cardiac_tpu/data/biobank.py``, copied onto the
port's DICOM reader and NIfTI writer; its NIfTIs are byte-identical.

Twin of ``data/biobank_utils.py`` on this framework's own DICOM reader
(``data/dicom.py``) and NIfTI writer.  Reproduces:
- series-directory recognition by name (SAX per-slice dirs, LAX 2/3/4Ch,
  aorta, LVOT, flow, ShMOLLI, tagging; ``biobank_utils.py:93-125``)
- splitting mixed SAX/LAX directories by CardiacNumberOfImages (:127-167)
- multi-series disambiguation via SeriesInstanceUID, preferring the
  annotated series when a cvi42 contour dir is given (:202-239)
- 4D volume assembly sorted by TriggerTime, with duplicate-previous-frame
  fallbacks for missing/corrupt files (:323-363)
- LPS→RAS affine construction from ImagePositionPatient /
  ImageOrientationPatient / SpacingBetweenSlices (:261-311)
- cvi42 contour rasterisation with cv2.fillPoly on a 4x upsampled grid,
  stored as ``label_<seq>`` (downsampled) + ``label_up_<seq>`` (:365-448)
"""

from __future__ import annotations

import os
import pickle
import re
import shutil
from typing import Dict, List, Optional

import cv2
import numpy as np

from ukbb_cardiac_tpu_torch.data import dicom
from ukbb_cardiac_tpu_torch.io import nifti


def repl(m):
    """Reformat 'Mon DD, 20YY' dates (``biobank_utils.py:36-38``)."""
    return "{}{}-{}-20{}".format(m.group(1), m.group(2), m.group(3), m.group(4))


def process_manifest(name, name2):
    """Remove the comma from manifest date fields (``biobank_utils.py:41-50``)."""
    with open(name2, "w") as f2:
        with open(name, "r") as f:
            for line in f:
                f2.write(re.sub(r"([A-Z])(\w{2}) (\d{1,2}), 20(\d{2})", repl, line))


class BaseImage:
    """Array + image-to-world affine + temporal spacing
    (``biobank_utils.py:53-63``)."""

    def __init__(self, volume=None, affine=None, dt=1):
        self.volume = np.array([]) if volume is None else volume
        self.affine = np.eye(4) if affine is None else affine
        self.dt = dt

    def WriteToNifti(self, filename):
        nim = nifti.Nifti1Image(self.volume, self.affine)
        nim.header["pixdim"][4] = self.dt
        nifti.save(nim, filename)


# directory-name patterns → sequence key (biobank_utils.py:93-125)
_SINGLE_DIR_SEQS = [
    (r"CINE_segmented_LAX_2Ch$", "la_2ch"),
    (r"CINE_segmented_LAX_3Ch$", "la_3ch"),
    (r"CINE_segmented_LAX_4Ch$", "la_4ch"),
    (r"CINE_segmented_Ao_dist$", "ao"),
    (r"CINE_segmented_LVOT$", "lvot"),
    (r"flow_250_tp_AoV_bh_ePAT@c$", "flow"),
    (r"flow_250_tp_AoV_bh_ePAT@c_MAG$", "flow_mag"),
    (r"flow_250_tp_AoV_bh_ePAT@c_P$", "flow_pha"),
    (r"ShMOLLI_192i_SAX_b2s$", "shmolli"),
    (r"ShMOLLI_192i_SAX_b2s_SAX_b2s_FITPARAMS$", "shmolli_fitpar"),
    (r"ShMOLLI_192i_SAX_b2s_SAX_b2s_SAX_b2s_T1MAP$", "shmolli_t1map"),
]


class Biobank_Dataset:
    """Manage one subject's DICOM series directories
    (``biobank_utils.py:66-453``)."""

    def __init__(self, input_dir: str, cvi42_dir: Optional[str] = None):
        self.subdir: Dict[str, List[str]] = {}
        self.data: Dict[str, BaseImage] = {}
        self.cvi42_dir = cvi42_dir

        subdirs = sorted(os.listdir(input_dir))
        sax_dirs, tag_dirs = [], []
        singles: Dict[str, str] = {}
        sax_mix = lax_mix = None
        for s in subdirs:
            m = re.match(r"CINE_segmented_SAX_b(\d*)$", s)
            if m:
                sax_dirs.append((os.path.join(input_dir, s), int(m.group(1))))
                continue
            if re.match(r"CINE_segmented_SAX$", s):
                sax_mix = os.path.join(input_dir, s)
                continue
            if re.match(r"CINE_segmented_LAX$", s):
                lax_mix = os.path.join(input_dir, s)
                continue
            for pat, key in _SINGLE_DIR_SEQS:
                if re.match(pat, s):
                    singles[key] = os.path.join(input_dir, s)
                    break
            m = re.match(r"cine_tagging_3sl_SAX_b(\d*)s$", s)
            if m:
                tag_dirs.append((os.path.join(input_dir, s), int(m.group(1))))

        if not sax_dirs and sax_mix:
            print("Warning: SAX subdirectories not found! Splitting the "
                  "mixed SAX directory into per-slice directories.")
            sax_dirs = self._split_mixed_sax(input_dir, sax_mix)

        if not any(k in singles for k in ("la_2ch", "la_3ch", "la_4ch")) and lax_mix:
            print("Warning: LAX subdirectories not found! Splitting the "
                  "mixed LAX directory into 2Ch/3Ch/4Ch views.")
            singles.update(self._split_mixed_lax(input_dir, lax_mix))

        if sax_dirs:
            self.subdir["sa"] = [d for d, _ in sorted(sax_dirs, key=lambda v: v[1])]
        for key, d in singles.items():
            self.subdir[key] = [d]
        for d, idx in sorted(tag_dirs, key=lambda v: v[1]):
            self.subdir[f"tag_{idx}"] = [d]

    @staticmethod
    def _split_mixed_sax(input_dir, sax_mix):
        files = sorted(os.listdir(sax_mix))
        d = dicom.dcmread(os.path.join(sax_mix, files[0]))
        T = int(d.CardiacNumberOfImages)
        Z = len(files) // T
        out = []
        for z in range(Z):
            s = os.path.join(input_dir, f"CINE_segmented_SAX_b{z}")
            os.mkdir(s)
            for f in files[z * T:(z + 1) * T]:
                shutil.move(os.path.join(sax_mix, f), s)
            out.append((s, z))
        return out

    @staticmethod
    def _split_mixed_lax(input_dir, lax_mix):
        files = sorted(os.listdir(lax_mix))
        d = dicom.dcmread(os.path.join(lax_mix, files[0]))
        T = int(d.CardiacNumberOfImages)
        if len(files) != 3 * T:
            print("Error: cannot split files into three partitions!")
            return {}
        out = {}
        # order in the mixed dir: 3Ch, 4Ch, 2Ch (biobank_utils.py:154-167)
        for key, (a, b) in (("la_3ch", (0, T)), ("la_4ch", (T, 2 * T)),
                            ("la_2ch", (2 * T, 3 * T))):
            name = {"la_2ch": "CINE_segmented_LAX_2Ch",
                    "la_3ch": "CINE_segmented_LAX_3Ch",
                    "la_4ch": "CINE_segmented_LAX_4Ch"}[key]
            dest = os.path.join(input_dir, name)
            os.mkdir(dest)
            for f in files[a:b]:
                shutil.move(os.path.join(lax_mix, f), dest)
            out[key] = dest
        return out

    def find_series(self, dir_name: str, T: int) -> List[str]:
        """Pick one series when a folder holds several
        (``biobank_utils.py:202-239``): prefer an annotated series, else
        the last UID; warn when files < T."""
        files = sorted(os.listdir(dir_name))
        if len(files) > T:
            series: Dict[str, List[str]] = {}
            for f in files:
                d = dicom.dcmread(os.path.join(dir_name, f))
                series.setdefault(d.SeriesInstanceUID, []).append(f)
            choose_suid = None
            if self.cvi42_dir:
                for suid, suid_files in series.items():
                    for f in suid_files:
                        pkl = os.path.join(self.cvi42_dir,
                                           os.path.splitext(f)[0] + ".pickle")
                        if os.path.exists(pkl):
                            choose_suid = suid
                            break
                    if choose_suid:
                        break
            if choose_suid is None:
                choose_suid = sorted(series.keys())[-1]
            print(f"There are multiple series. Use series {choose_suid}.")
            files = sorted(series[choose_suid])
        if len(files) < T:
            print(f"Warning: {dir_name}: Number of files < "
                  f"CardiacNumberOfImages! We will fill the missing files "
                  f"using duplicate slices.")
        return files

    @staticmethod
    def _lps_to_ras_affine(d, d2, Z):
        """Affine from DICOM geometry (``biobank_utils.py:261-311``)."""
        dx = float(d.PixelSpacing[1])
        dy = float(d.PixelSpacing[0])
        pos_ul = np.asarray([float(v) for v in d.ImagePositionPatient])
        pos_ul[:2] = -pos_ul[:2]
        axis_x = np.asarray([float(v) for v in d.ImageOrientationPatient[:3]])
        axis_y = np.asarray([float(v) for v in d.ImageOrientationPatient[3:]])
        axis_x[:2] = -axis_x[:2]
        axis_y[:2] = -axis_y[:2]

        if Z >= 2 and d2 is not None:
            pos_ul2 = np.asarray([float(v) for v in d2.ImagePositionPatient])
            pos_ul2[:2] = -pos_ul2[:2]
            axis_z = pos_ul2 - pos_ul
            axis_z = axis_z / np.linalg.norm(axis_z)
        else:
            pos_ul2 = None
            axis_z = np.cross(axis_x, axis_y)

        if "SpacingBetweenSlices" in d:
            dz = float(d.SpacingBetweenSlices)
        elif pos_ul2 is not None:
            print("Warning: can not find attribute SpacingBetweenSlices. "
                  "Calculate from two successive slices.")
            dz = float(np.linalg.norm(pos_ul2 - pos_ul))
        else:
            print("Warning: can not find attribute SpacingBetweenSlices. "
                  "Use attribute SliceThickness instead.")
            dz = float(d.SliceThickness)

        affine = np.eye(4)
        affine[:3, 0] = axis_x * dx
        affine[:3, 1] = axis_y * dy
        affine[:3, 2] = axis_z * dz
        affine[:3, 3] = pos_ul
        return affine

    # cvi42 contour fill order and labels (biobank_utils.py:372-404)
    _CONTOUR_ORDER = [
        ("sarvendocardialContour", 3),
        ("saepicardialContour", 2), ("saepicardialOpenContour", 2),
        ("saendocardialContour", 1), ("saendocardialOpenContour", 1),
        ("laraContour", 2), ("lalaContour", 1),
    ]

    @staticmethod
    def rasterise_contours(contours: dict, X: int, Y: int, up: int = 4):
        """Fill cvi42 polygons on a 4x-upsampled grid
        (``biobank_utils.py:406-421``). Returns (label_up(Y*up, X*up))."""
        lab_up = np.zeros((Y * up, X * up))
        for key, lab in Biobank_Dataset._CONTOUR_ORDER:
            if key in contours:
                # int32: cv2 4.x rejects CV_64S point arrays (5.x accepts)
                coord = np.round(np.asarray(contours[key]) * up).astype(np.int32)
                cv2.fillPoly(lab_up, [coord], lab)
        return lab_up

    def read_dicom_images(self) -> None:
        """Assemble 4D volumes (+labels) per sequence
        (``biobank_utils.py:241-448``)."""
        up = 4
        for name, dirs in sorted(self.subdir.items()):
            Z = len(dirs)
            first = sorted(os.listdir(dirs[0]))[0]
            d = dicom.dcmread(os.path.join(dirs[0], first))
            T = int(d.CardiacNumberOfImages)
            d = dicom.dcmread(os.path.join(dirs[0],
                                           self.find_series(dirs[0], T)[0]))
            X = int(d.Columns)
            Y = int(d.Rows)
            T = int(d.CardiacNumberOfImages)

            d2 = None
            if Z >= 2:
                d2 = dicom.dcmread(
                    os.path.join(dirs[1], sorted(os.listdir(dirs[1]))[0]))
            affine = self._lps_to_ras_affine(d, d2, Z)

            volume = np.zeros((X, Y, Z, T), dtype="float32")
            label = label_up = None
            if self.cvi42_dir:
                label = np.zeros((X, Y, Z, T), dtype="int16")
                label_up = np.zeros((X * up, Y * up, Z, T), dtype="int16")

            files_time = []
            for z in range(Z):
                files = self.find_series(dirs[z], T)
                files_time = []
                for f in files:
                    # parse once; the object is reused for pixel data below
                    # (each dcmread slurps the whole file incl. PixelData,
                    # so re-reading doubled conversion I/O)
                    dd = dicom.dcmread(os.path.join(dirs[z], f))
                    files_time.append((f, float(dd.TriggerTime), dd))
                files_time = sorted(files_time, key=lambda v: v[1])

                for t in range(T):
                    f = None
                    try:
                        f, _, dd = files_time[t]
                        # pixel_array is (rows=Y, cols=X); transpose → (X, Y)
                        volume[:, :, z, t] = dd.pixel_array.transpose()
                    except IndexError:
                        print(f"Warning: dicom file missing for {dirs[z]}: "
                              f"time point {t}. Image will be copied from the "
                              f"previous time point.")
                        volume[:, :, z, t] = volume[:, :, z, t - 1]
                    except (ValueError, TypeError, AttributeError,
                            dicom.UnsupportedDicom):
                        print(f"Warning: failed to read pixel_array from file "
                              f"{os.path.join(dirs[z], str(f))}. Image will be "
                              f"copied from the previous time point.")
                        volume[:, :, z, t] = volume[:, :, z, t - 1]

                    if self.cvi42_dir and f is not None:
                        pkl = os.path.join(self.cvi42_dir,
                                           os.path.splitext(f)[0] + ".pickle")
                        if os.path.exists(pkl):
                            with open(pkl, "rb") as fh:
                                contours = pickle.load(fh)
                            lab_up = self.rasterise_contours(contours, X, Y, up)
                            label_up[:, :, z, t] = lab_up.transpose()
                            label[:, :, z, t] = lab_up[::up, ::up].transpose()

            try:
                dt = (files_time[1][1] - files_time[0][1]) * 1e-3
            except IndexError:
                dt = 1

            self.data[name] = BaseImage(volume, affine, dt)
            if self.cvi42_dir:
                if np.any(label):
                    self.data["label_" + name] = BaseImage(label, affine, dt)
                if np.any(label_up):
                    up_matrix = np.diag([1.0 / up, 1.0 / up, 1.0, 1.0])
                    self.data["label_up_" + name] = BaseImage(
                        label_up, affine @ up_matrix, dt)

    def convert_dicom_to_nifti(self, output_dir: str) -> None:
        """Write every assembled sequence as NIfTI (``biobank_utils.py:450-453``)."""
        for name, image in self.data.items():
            image.WriteToNifti(os.path.join(output_dir, f"{name}.nii.gz"))

"""QM9 acquisition and repack (scripts/prepare_qm9.py): the 133,885
per-molecule xyz files of dsgdb9nsd.xyz.tar.bz2 (figshare id 3195389)
repacked into one concatenated xyz with a 12-value property header per
molecule (mu, alpha, HOMO, LUMO, gap, r2, zpve, U0, U, H, G, Cv:
`split()[5:]` of the QM9 comment line) and the `*^` -> `E` float fixup,
the layout `data/molecule.py::read_xyz_allprop` reads.

    python -m x2gnn_tpu_torch.scripts.prepare_qm9 \\
        --out ./raw/qm9_origin.xyz [--workdir ./raw]
    # then featurize and train:
    python -m x2gnn_tpu_torch.train --data ./raw/qm9_origin.xyz \\
        --target 7 --backend native

A tarball already at `<workdir>/dsgdb9nsd.xyz.tar.bz2` is used as it is
(nothing is downloaded), and an existing `<workdir>/dsgdb9nsd_xyz/` is
not extracted again: on a machine without network, place the tarball
there first. The script touches no device.
"""

from __future__ import annotations

import argparse
import os
import sys
import tarfile
import urllib.request

QM9_URL = "https://figshare.com/ndownloader/files/3195389"
QM9_COUNT = 133885


def download(url: str, dest: str) -> str:
    """`dest`, fetched from `url` unless it exists."""
    if os.path.exists(dest):
        print(f"using existing {dest}", file=sys.stderr)
        return dest
    print(f"downloading {url} -> {dest}", file=sys.stderr)
    urllib.request.urlretrieve(url, dest)
    return dest


def extract(tar_path: str, xyz_dir: str) -> None:
    """The tarball's files into `xyz_dir`, unless that directory exists."""
    if os.path.isdir(xyz_dir):
        return
    os.makedirs(xyz_dir, exist_ok=True)
    print("extracting...", file=sys.stderr)
    with tarfile.open(tar_path, "r:bz2") as tf:
        tf.extractall(xyz_dir, filter="data")


def repack(xyz_dir: str, out_path: str, count: int = QM9_COUNT) -> None:
    """`dsgdb9nsd_000001.xyz` .. `dsgdb9nsd_<count>.xyz` of `xyz_dir` into
    one file: per molecule its atom count, its 12 properties tab-joined,
    then `element x y z` per atom (the Mulliken column and the trailer
    lines dropped, `*^` read as `E`); a missing file raises."""
    with open(out_path, "w") as out:
        for i in range(count):
            path = os.path.join(xyz_dir, f"dsgdb9nsd_{i + 1:06d}.xyz")
            with open(path, "r") as f:
                lines = f.readlines()
            n_atoms = int(lines[0])
            props = "\t".join(lines[1].split()[5:])
            out.write(f"{n_atoms}\n{props}\n")
            for line in lines[2:2 + n_atoms]:
                tok = line.replace("*^", "E").split()
                out.write("\t".join(tok[:4]) + "\n")
            if (i + 1) % 20000 == 0:
                print(f"{i + 1}/{count}", file=sys.stderr)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="./raw/qm9_origin.xyz")
    p.add_argument("--workdir", default="./raw")
    p.add_argument("--url", default=QM9_URL)
    args = p.parse_args(argv)

    os.makedirs(args.workdir, exist_ok=True)
    tar_path = os.path.join(args.workdir, "dsgdb9nsd.xyz.tar.bz2")
    download(args.url, tar_path)
    xyz_dir = os.path.join(args.workdir, "dsgdb9nsd_xyz")
    extract(tar_path, xyz_dir)
    repack(xyz_dir, args.out, QM9_COUNT)
    print(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

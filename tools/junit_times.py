"""Seconds per test file from a pytest JUnit XML file.

    python3 tools/junit_times.py RUN.xml [NAME ...]

Sums each test file's case times (setup, call and teardown, as pytest
writes them) and prints one line per file, slowest first: its name, its
cases, its seconds and its failures, then the total of the files shown
and the run's own counts.  With NAMEs, only the files whose name is one
of them are shown, e.g. the port's files with 8 or more cases:

    python3 tools/junit_times.py /tmp/_t1.xml test_torch_oem test_torch_clearsky \\
        test_torch_lbl test_torch_measurement test_torch_rtepack test_torch_zeeman \\
        test_torch_package test_torch_eigh
"""

import collections
import sys
import xml.etree.ElementTree as ET


def main(path, names):
    root = ET.parse(path).getroot()
    files = collections.defaultdict(lambda: [0, 0.0, 0])
    for case in root.iter("testcase"):
        name = case.get("classname", "").split(".")[-1]
        row = files[name]
        row[0] += 1
        row[1] += float(case.get("time", 0.0))
        row[2] += case.find("failure") is not None or case.find("error") is not None
    shown = [(n, r) for n, r in files.items() if not names or n in names]
    for name, (cases, seconds, failed) in sorted(shown, key=lambda nr: -nr[1][1]):
        print(f"{name:40s} {cases:4d} {seconds:8.1f} failed={failed}")
    print(f"total {sum(r[1] for _, r in shown):.1f} s")
    suite = root if root.tag == "testsuite" else root.find("testsuite")
    print({k: suite.get(k) for k in ("tests", "errors", "failures", "skipped", "time")})


if __name__ == "__main__":
    main(sys.argv[1], set(sys.argv[2:]))

"""Host I/O: HIS projections, ddbvf volumes, geometry/angle files, streaming."""

from .his import read_his, write_his, HisHeader
from .ddbvf import create, open_meta, write_slices, read_slices, read_volume
from .geometry_file import load_geometry_file, parse_geometry_text, dump_geometry_file
from .angles import read_angles, angles_for
from .source import Projection, ProjectionSource, scan_directory

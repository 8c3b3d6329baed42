// Shared flattened asset struct for the native loader cores (URDF + MJCF).
// Both parsers emit the same IgUrdf layout, consumed via ctypes
// (isaacgym_tpu_torch/native/__init__.py) and rebuilt into models.urdf.UrdfModel.
#ifndef ISAACGYM_TPU_NATIVE_IG_ASSET_H_
#define ISAACGYM_TPU_NATIVE_IG_ASSET_H_

#include <cstdlib>
#include <cstring>
#include <string>

extern "C" {

struct IgUrdf {
  int n_links, n_joints, n_geoms;
  double* link_mass;      // n_links
  double* link_com;       // n_links*3
  double* link_inertia;   // n_links*9 (row major 3x3)
  char** link_names;
  int* joint_kind;        // 0 fixed, 1 revolute/continuous, 2 prismatic
  int* joint_parent;      // link index
  int* joint_child;       // link index
  double* joint_origin;   // n_joints*6 (xyz, rpy)
  double* joint_axis;     // n_joints*3
  double* joint_limit;    // n_joints*4 (lower, upper, effort, velocity)
  double* joint_dynamics; // n_joints*3 (damping, friction, armature)
  char** joint_names;
  int* geom_link;
  int* geom_kind;         // 0 sphere, 1 box, 2 cylinder
  double* geom_origin;    // n_geoms*6
  double* geom_size;      // n_geoms*3 (sphere r; box half-extents; cyl r, half-len)
  char* robot_name;
};

void ig_free_urdf(IgUrdf* u);  // defined in urdf_parser.cpp

}  // extern "C"

inline char* IgDup(const std::string& s) {
  char* out = static_cast<char*>(std::malloc(s.size() + 1));
  std::memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

inline IgUrdf* IgAlloc(int n_links, int n_joints, int n_geoms) {
  IgUrdf* u = static_cast<IgUrdf*>(std::calloc(1, sizeof(IgUrdf)));
  u->n_links = n_links;
  u->n_joints = n_joints;
  u->n_geoms = n_geoms;
  u->link_mass = static_cast<double*>(std::calloc(n_links, sizeof(double)));
  u->link_com = static_cast<double*>(std::calloc(n_links * 3, sizeof(double)));
  u->link_inertia = static_cast<double*>(std::calloc(n_links * 9, sizeof(double)));
  u->link_names = static_cast<char**>(std::calloc(n_links, sizeof(char*)));
  u->joint_kind = static_cast<int*>(std::calloc(n_joints, sizeof(int)));
  u->joint_parent = static_cast<int*>(std::calloc(n_joints, sizeof(int)));
  u->joint_child = static_cast<int*>(std::calloc(n_joints, sizeof(int)));
  u->joint_origin = static_cast<double*>(std::calloc(n_joints * 6, sizeof(double)));
  u->joint_axis = static_cast<double*>(std::calloc(n_joints * 3, sizeof(double)));
  u->joint_limit = static_cast<double*>(std::calloc(n_joints * 4, sizeof(double)));
  u->joint_dynamics = static_cast<double*>(std::calloc(n_joints * 3, sizeof(double)));
  u->joint_names = static_cast<char**>(std::calloc(n_joints, sizeof(char*)));
  u->geom_link = static_cast<int*>(std::calloc(n_geoms, sizeof(int)));
  u->geom_kind = static_cast<int*>(std::calloc(n_geoms, sizeof(int)));
  u->geom_origin = static_cast<double*>(std::calloc(n_geoms * 6, sizeof(double)));
  u->geom_size = static_cast<double*>(std::calloc(n_geoms * 3, sizeof(double)));
  return u;
}

#endif  // ISAACGYM_TPU_NATIVE_IG_ASSET_H_

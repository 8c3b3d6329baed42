// Native URDF asset-loader core (SURVEY.md §2 N3).
//
// The reference loads assets through Isaac Gym's native C++ parser
// (gym.load_asset). This is the TPU-framework equivalent: a dependency-free
// C++ URDF parser that extracts the flattened arrays the kinematic-tree
// compiler consumes (links: mass/com/inertia; joints: topology, frames,
// axes, limits, dynamics; collision primitives). Exposed through a plain C
// API consumed via ctypes (isaacgym_tpu_torch/native/__init__.py); the Python
// parser in models/urdf.py remains as a verified fallback.
//
// Build (with the MJCF core, one shared library):
//   g++ -O2 -shared -fPIC -std=c++17 -o libig_assets.so \
//       urdf_parser.cpp mjcf_parser.cpp

#include <cstdio>
#include <fstream>
#include <map>
#include <sstream>
#include <string>
#include <vector>

#include "ig_asset.h"
#include "xml_mini.h"

using igxml::AttrF;
using igxml::Child;
using igxml::ParseFloats;
using igxml::XmlNode;
using igxml::XmlParser;

extern "C" {

void ig_free_urdf(IgUrdf* u) {
  if (!u) return;
  for (int i = 0; i < u->n_links; i++) std::free(u->link_names[i]);
  for (int i = 0; i < u->n_joints; i++) std::free(u->joint_names[i]);
  std::free(u->link_names);
  std::free(u->joint_names);
  std::free(u->link_mass);
  std::free(u->link_com);
  std::free(u->link_inertia);
  std::free(u->joint_kind);
  std::free(u->joint_parent);
  std::free(u->joint_child);
  std::free(u->joint_origin);
  std::free(u->joint_axis);
  std::free(u->joint_limit);
  std::free(u->joint_dynamics);
  std::free(u->geom_link);
  std::free(u->geom_kind);
  std::free(u->geom_origin);
  std::free(u->geom_size);
  std::free(u->robot_name);
  std::free(u);
}

IgUrdf* ig_parse_urdf(const char* path, char* errbuf, int errlen) {
  std::ifstream f(path);
  if (!f) {
    std::snprintf(errbuf, errlen, "cannot open %s", path);
    return nullptr;
  }
  std::stringstream buf;
  buf << f.rdbuf();
  std::string text = buf.str();

  XmlNode root;
  std::string err;
  XmlParser parser(text);
  if (!parser.Parse(&root, &err) || root.tag != "robot") {
    std::snprintf(errbuf, errlen, "parse error: %s", err.c_str());
    return nullptr;
  }

  std::vector<const XmlNode*> links, joints;
  for (const auto& c : root.children) {
    if (c.tag == "link") links.push_back(&c);
    if (c.tag == "joint") joints.push_back(&c);
  }
  std::map<std::string, int> link_idx;
  for (size_t i = 0; i < links.size(); i++) {
    auto it = links[i]->attrs.find("name");
    if (it == links[i]->attrs.end()) {
      std::snprintf(errbuf, errlen, "link %zu missing name", i);
      return nullptr;
    }
    link_idx[it->second] = static_cast<int>(i);
  }

  int n_links = static_cast<int>(links.size());
  int n_joints = static_cast<int>(joints.size());
  int n_geoms = 0;
  for (auto* l : links)
    for (const auto& c : l->children)
      if (c.tag == "collision") n_geoms++;

  IgUrdf* u = IgAlloc(n_links, n_joints, n_geoms);
  auto name_it = root.attrs.find("name");
  u->robot_name = IgDup(name_it == root.attrs.end() ? "robot" : name_it->second);

  int gi = 0;
  for (int i = 0; i < n_links; i++) {
    const XmlNode* l = links[i];
    u->link_names[i] = IgDup(l->attrs.at("name"));
    if (const XmlNode* inertial = Child(*l, "inertial")) {
      if (const XmlNode* m = Child(*inertial, "mass")) u->link_mass[i] = AttrF(*m, "value");
      if (const XmlNode* o = Child(*inertial, "origin")) {
        auto it = o->attrs.find("xyz");
        if (it != o->attrs.end()) ParseFloats(it->second, &u->link_com[i * 3], 3);
      }
      if (const XmlNode* in = Child(*inertial, "inertia")) {
        double ixx = AttrF(*in, "ixx"), iyy = AttrF(*in, "iyy"), izz = AttrF(*in, "izz");
        double ixy = AttrF(*in, "ixy"), ixz = AttrF(*in, "ixz"), iyz = AttrF(*in, "iyz");
        double* I = &u->link_inertia[i * 9];
        I[0] = ixx; I[1] = ixy; I[2] = ixz;
        I[3] = ixy; I[4] = iyy; I[5] = iyz;
        I[6] = ixz; I[7] = iyz; I[8] = izz;
      }
    }
    for (const auto& c : l->children) {
      if (c.tag != "collision") continue;
      u->geom_link[gi] = i;
      if (const XmlNode* o = Child(c, "origin")) {
        auto it = o->attrs.find("xyz");
        if (it != o->attrs.end()) ParseFloats(it->second, &u->geom_origin[gi * 6], 3);
        it = o->attrs.find("rpy");
        if (it != o->attrs.end()) ParseFloats(it->second, &u->geom_origin[gi * 6 + 3], 3);
      }
      if (const XmlNode* g = Child(c, "geometry")) {
        if (const XmlNode* sp = Child(*g, "sphere")) {
          u->geom_kind[gi] = 0;
          u->geom_size[gi * 3] = AttrF(*sp, "radius");
        } else if (const XmlNode* bx = Child(*g, "box")) {
          u->geom_kind[gi] = 1;
          double full[3];
          ParseFloats(bx->attrs.at("size"), full, 3);
          for (int k = 0; k < 3; k++) u->geom_size[gi * 3 + k] = full[k] / 2.0;
        } else if (const XmlNode* cy = Child(*g, "cylinder")) {
          u->geom_kind[gi] = 2;
          u->geom_size[gi * 3] = AttrF(*cy, "radius");
          u->geom_size[gi * 3 + 1] = AttrF(*cy, "length") / 2.0;
        }
      }
      gi++;
    }
  }

  for (int j = 0; j < n_joints; j++) {
    const XmlNode* jn = joints[j];
    u->joint_names[j] = IgDup(jn->attrs.count("name") ? jn->attrs.at("name") : "joint");
    std::string type = jn->attrs.count("type") ? jn->attrs.at("type") : "fixed";
    bool continuous = (type == "continuous");
    u->joint_kind[j] = (type == "revolute" || continuous) ? 1
                       : (type == "prismatic") ? 2 : 0;
    const XmlNode* p = Child(*jn, "parent");
    const XmlNode* c = Child(*jn, "child");
    if (!p || !c || !link_idx.count(p->attrs.at("link")) ||
        !link_idx.count(c->attrs.at("link"))) {
      std::snprintf(errbuf, errlen, "joint %s has bad parent/child",
                    u->joint_names[j]);
      ig_free_urdf(u);
      return nullptr;
    }
    u->joint_parent[j] = link_idx[p->attrs.at("link")];
    u->joint_child[j] = link_idx[c->attrs.at("link")];
    if (const XmlNode* o = Child(*jn, "origin")) {
      auto it = o->attrs.find("xyz");
      if (it != o->attrs.end()) ParseFloats(it->second, &u->joint_origin[j * 6], 3);
      it = o->attrs.find("rpy");
      if (it != o->attrs.end()) ParseFloats(it->second, &u->joint_origin[j * 6 + 3], 3);
    }
    u->joint_axis[j * 3] = 1.0;  // URDF default axis (1,0,0)
    if (const XmlNode* a = Child(*jn, "axis")) {
      auto it = a->attrs.find("xyz");
      if (it != a->attrs.end()) ParseFloats(it->second, &u->joint_axis[j * 3], 3);
    }
    if (const XmlNode* lim = Child(*jn, "limit")) {
      u->joint_limit[j * 4 + 0] = AttrF(*lim, "lower");
      u->joint_limit[j * 4 + 1] = AttrF(*lim, "upper");
      u->joint_limit[j * 4 + 2] = AttrF(*lim, "effort");
      u->joint_limit[j * 4 + 3] = AttrF(*lim, "velocity");
    } else if (continuous) {
      u->joint_limit[j * 4 + 0] = -3.14159265358979;
      u->joint_limit[j * 4 + 1] = 3.14159265358979;
    }
    if (const XmlNode* dyn = Child(*jn, "dynamics")) {
      u->joint_dynamics[j * 3 + 0] = AttrF(*dyn, "damping");
      u->joint_dynamics[j * 3 + 1] = AttrF(*dyn, "friction");
      u->joint_dynamics[j * 3 + 2] = AttrF(*dyn, "armature");
    }
  }

  return u;
}

}  // extern "C"
